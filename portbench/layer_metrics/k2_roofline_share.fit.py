"""K2's share of its roofline in the fits, in percent.

The least time of every K2 launch in the traced window, from its
(m, d, k) in the port's launch counter and the configuration's
iterations (``work.fixed_kernel_work``, ``work.bound_ms``), over the
device time of the K2 kernels in the trace.
"""

from portbench import trace, work


def read(tr):
    bound = sum(n * work.bound_ms(*work.fixed_kernel_work(m, d, k, tr.config["max_iters"]))
                for (name, m, d, k), n in tr.launch_shapes.items() if name == "dantzig_fused")
    took = sum(ev.end - ev.start for ev in trace.kernels(tr, lambda s: trace.admm_kind(s) == "K2"))
    if not bound or not took:
        return None
    return 100.0 * bound / (took / 1e6)
