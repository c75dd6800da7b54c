"""Device kernels a refinement round launches: the kernels launched inside the port's
``repro_torch.rounds.round`` spans in the traced window, over the number of those spans (one a
round executed)."""

from portbench import spans, trace

ROUND = "repro_torch.rounds.round"


def read(tr):
    n = spans.count(tr, ROUND)
    if not n:
        return None
    opened = {}
    for op in tr.host:
        if op.span and op.name == ROUND:
            opened.setdefault(op.thread, []).append((op.start, op.end))
    launched = sum(1 for ev in trace.kernels(tr) if ev.host >= 0 and any(
        s <= ev.host <= e for s, e in opened.get(ev.thread, ())))
    return launched / n
