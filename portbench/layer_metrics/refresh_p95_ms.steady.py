"""95th percentile, in milliseconds, over every ``refresh`` of the run's untraced window, on the
host's clock: from the call to ``refresh`` until the new slot is published and the device
synchronised, the time to a fresh model."""

import numpy as np


def read(tr):
    took = tr.host_timed.get("refresh")
    return float(np.percentile(took, 95)) * 1e3 if took else None
