"""Device milliseconds of K3 (the warm-state, tol-gated ADMM kernel) a refresh takes: the K3
kernels' device time in the traced window, over the refreshes."""

from portbench import trace


def read(tr):
    refreshes = tr.counts.get("refreshes")
    took = sum(ev.end - ev.start for ev in trace.kernels(tr, lambda s: trace.admm_kind(s) == "K3"))
    return took / 1e6 / refreshes if refreshes and took else None
