"""95th percentile, in milliseconds, over every ``classify`` call of the run's untraced window, on
the host's clock: from handing a query batch to the runtime until its predictions are on the host
(the tick ends in that blocking copy)."""

import numpy as np


def read(tr):
    took = tr.host_timed.get("classify")
    return float(np.percentile(took, 95)) * 1e3 if took else None
