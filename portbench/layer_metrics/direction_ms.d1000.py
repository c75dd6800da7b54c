"""Device milliseconds a fit spends on the direction solve: every device operation launched inside
the port's ``repro_torch.solve.direction`` span, its one-column K2 kernel on the streamed template
included (``portbench.streamed``), over the fits."""

from portbench import streamed


def read(tr):
    return streamed.device_ms_per_fit(tr, "repro_torch.solve.direction")
