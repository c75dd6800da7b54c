"""Device milliseconds a fit spends in its refinement rounds: the device time of everything
launched inside the port's ``repro_torch.rounds`` span (the corrections, the masked aggregates,
the broadcasts) in the traced window, over the fits."""

from portbench import trace


def read(tr):
    fits = tr.counts.get("fits")
    took = trace.device_ns_under(tr, "repro_torch.rounds")
    return took / 1e6 / fits if fits and took else None
