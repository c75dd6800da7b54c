"""Device milliseconds a fit spends on K2's streamed template: each ADMM kernel paired with the
port's ``repro_torch.admm.streamed`` span that launched it, and the A^T, Q^T that span builds
(``portbench.streamed``), over the fits."""

from portbench import streamed


def read(tr):
    return streamed.device_ms_per_fit(tr, streamed.STREAMED)
