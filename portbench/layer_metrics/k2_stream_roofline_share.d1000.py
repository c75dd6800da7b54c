"""K2's streamed template's share of its roofline in the fits, in percent.

The least time of every K2 launch in the traced window, from its
(m, d, k) in the port's launch counter and the configuration's
iterations (``work.fixed_kernel_work``, ``work.bound_ms``), over the
device time of the K2 kernels, each paired with the port's
``repro_torch.admm.streamed`` span that launched it
(``portbench.streamed``).  ``None`` when any ADMM kernel of the window
has no such span: a launch on the cluster template, or a program
without the span.
"""

from portbench import streamed, trace, work


def read(tr):
    pairs = streamed.launches(tr)
    if pairs is None:
        return None
    bound = sum(n * work.bound_ms(*work.fixed_kernel_work(m, d, k, tr.config["max_iters"]))
                for (name, m, d, k), n in tr.launch_shapes.items() if name == "dantzig_fused")
    took = sum(ev.end - ev.start for _, ev in pairs if trace.admm_kind(ev.name) == "K2")
    if not bound or not took:
        return None
    return 100.0 * bound / (took / 1e6)
