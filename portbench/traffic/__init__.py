"""Traffic drivers: each a general generator and timed loop that one cell's parameters drive.

A driver module gives ``setup(cell, device, seed, system)`` (draw the
inputs, build the system under test, warm up every shape the cell
uses), ``run(setup, seconds=..., units=...)`` (the closed loop, timed
as a whole; ``units`` fixes the amount of work instead, for the traced
run), ``end_to_end(record)``, ``counts(record)`` and
``judge(setup, record)`` (the reference's verdict on every answer the
run produced).  ``system`` is ``"program"`` (the port) or
``"control"`` (the reference in TF32, put in the port's place).  A
driver whose cells have per-layer metrics on the host's clock also
gives ``timed(record)``: each call's seconds, by the call's name.
Every driver also gives ``shrink_for_cpu_tests(config, traffic)``,
which shrinks a configuration and a traffic mix of its cells, in place,
to the CPU tests' sizes (``portbench.testing.tiny_root``); no run calls
it.
"""
