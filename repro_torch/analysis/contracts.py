"""Contract types checked against the counts of one call (twin of ``repro.analysis.contracts``).

Each contract is a small declarative object with a ``check(counts,
params)`` method returning :class:`Violation` records that name what
tripped it; ``counts`` is the :class:`~repro_torch.analysis.counts.OpCounts`
of one call.  Numeric fields accept a literal or :class:`Param`, a named
placeholder resolved against the case's params at check time -- so "T
rounds means T psums" stays declarative at the decoration site while the
case supplies T.

The reference's primitive names map onto the counted categories:
``eigh``; ``dot_general`` the matrix products; ``pallas_call`` the
hand-written kernels but K1 (on the card their launches, which must
equal the wrapper calls); ``psum`` and
``all_gather`` the logical collectives; ``is_finite`` the screening
calls; ``while`` and ``scan``, the reference's ADMM loops, the Dantzig
solves dispatched.  K1 has its own contract, :class:`GramLaunches`: the
reference's CPU trace never reaches its gram kernel, the port's
statistics launch K1 on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch


class Violation(NamedTuple):
    """One contract breach, with the counted sites that triggered it."""

    contract: str
    message: str
    sites: Tuple[str, ...] = ()

    def render(self) -> str:
        lines = [f"{self.contract}: {self.message}"]
        lines.extend(f"    at {s}" for s in self.sites)
        return "\n".join(lines)


class Param(NamedTuple):
    """Placeholder resolved against the case params dict at check time."""

    key: str


class MissingParam(KeyError):
    pass


def resolve(value, params):
    if isinstance(value, Param):
        if not params or value.key not in params:
            raise MissingParam(value.key)
        return params[value.key]
    return value


IntOrParam = Union[int, Param]
ShapeOrParam = Union[Tuple[int, ...], Param]

# every kernel of repro_torch.kernels.ops but K1 (GramLaunches)
ADMM_AND_SHRINK = ("dantzig_fused", "dantzig_fused_state", "soft_threshold")


def _kernel_sites(counts, kernels) -> Tuple[str, ...]:
    return tuple(f"{key[0]}{tuple(key[1:])} x{n}" for key, n in sorted(counts.call_shapes.items())
                 if key[0] in kernels)


def _launch_mismatch(counts, kernels) -> list:
    """On the card every wrapper call launches its kernel once: the kernels where not."""
    if not counts.on_card:
        return []
    return [k for k in kernels if counts.launches.get(k, 0) != counts.calls.get(k, 0)]


def _record_site(r) -> str:
    return (f"{r.op}[{','.join(r.axes)}] {r.dtype}{list(r.shape)} ({r.role}, {r.bits} bits)")


def _collective_sites(counts, op) -> Tuple[str, ...]:
    sites = tuple(_record_site(r) for r in counts.collectives if r.op == op)
    n = counts.unrecorded.get(op, 0)
    return sites + ((f"{n} c10d {op} outside repro_torch.core.collectives",) if n else ())


def _primitive(counts, prim: str) -> tuple[int, Tuple[str, ...]]:
    """(count, sites) of one of the reference's primitive names in the counts."""
    if prim == "eigh":
        return counts.eigh, (f"_linalg_eigh x{counts.eigh}",) if counts.eigh else ()
    if prim == "dot_general":
        return counts.matmul, ()
    if prim == "pallas_call":
        n = sum((counts.launches if counts.on_card else counts.calls).get(k, 0)
                for k in ADMM_AND_SHRINK)
        return n, _kernel_sites(counts, ADMM_AND_SHRINK)
    if prim in ("psum", "all_gather"):
        return counts.collective_count(prim), _collective_sites(counts, prim)
    if prim == "is_finite":
        return counts.is_finite, ()
    if prim in ("while", "scan"):
        return counts.solves, ()
    raise ValueError(f"no counted category for the primitive {prim!r}")


class PrimitiveBudget(NamedTuple):
    """Bound the number of occurrences of one primitive (the module's names) in the call.

    ``exact`` pins the count; ``max_count``/``min_count`` bound it.
    """

    prim: str
    exact: Optional[IntOrParam] = None
    max_count: Optional[IntOrParam] = None
    min_count: Optional[IntOrParam] = None

    def describe(self) -> str:
        parts = []
        if self.exact is not None:
            parts.append(f"=={self.exact}")
        if self.max_count is not None:
            parts.append(f"<={self.max_count}")
        if self.min_count is not None:
            parts.append(f">={self.min_count}")
        return f"budget[{self.prim} {' '.join(parts) or 'any'}]"

    def check(self, counts, params=None) -> list:
        n, sites = _primitive(counts, self.prim)
        violations = []

        def fail(expected: str):
            violations.append(Violation(
                self.describe(), f"found {n} `{self.prim}`, expected {expected}", sites))

        exact = resolve(self.exact, params)
        if exact is not None and n != exact:
            fail(f"exactly {exact}")
        max_count = resolve(self.max_count, params)
        if max_count is not None and n > max_count:
            fail(f"at most {max_count}")
        min_count = resolve(self.min_count, params)
        if min_count is not None and n < min_count:
            fail(f"at least {min_count}")
        if self.prim == "pallas_call":
            for k in _launch_mismatch(counts, ADMM_AND_SHRINK):
                violations.append(Violation(
                    self.describe(), f"{k}: {counts.calls.get(k, 0)} calls on the card but "
                    f"{counts.launches.get(k, 0)} launches", sites))
        return violations


class GramLaunches(NamedTuple):
    """K1 launches: ``exact`` on the card, none on the CPU (the statistics take the plain
    product there), and on the card one launch a call."""

    exact: IntOrParam

    def describe(self) -> str:
        return f"gram[=={self.exact} on the card, 0 on the CPU]"

    def check(self, counts, params=None) -> list:
        exact = resolve(self.exact, params)
        want = exact if counts.on_card else 0
        got = counts.launches.get("gram", 0) if counts.on_card else counts.calls.get("gram", 0)
        sites = _kernel_sites(counts, ("gram",))
        violations = []
        if got != want:
            where = "on the card" if counts.on_card else "on the CPU"
            violations.append(Violation(self.describe(),
                                        f"found {got} K1 {where}, expected {want}", sites))
        if _launch_mismatch(counts, ("gram",)):
            violations.append(Violation(
                self.describe(), f"{counts.calls.get('gram', 0)} K1 calls on the card but "
                f"{counts.launches.get('gram', 0)} launches", sites))
        return violations


class CollectiveContract(NamedTuple):
    """Pin a collective's count AND its payload shape/dtype per mesh axis.

    ``count`` matching collectives must exist (after the ``shape``
    payload filter, on the operand), every one of them over ``axis``
    and carrying ``dtype``.
    """

    prim: str  # "psum" | "all_gather"
    count: IntOrParam
    axis: Optional[str] = None
    shape: Optional[ShapeOrParam] = None
    dtype: Optional[str] = None

    def describe(self) -> str:
        bits = [f"x{self.count}"]
        if self.axis:
            bits.append(f"axis={self.axis}")
        if self.shape is not None:
            bits.append(f"payload={self.shape}")
        if self.dtype:
            bits.append(self.dtype)
        return f"collective[{self.prim} {' '.join(bits)}]"

    def check(self, counts, params=None) -> list:
        shape = resolve(self.shape, params)
        found = [r for r in counts.collectives if r.op == self.prim
                 and (shape is None or r.shape == tuple(shape))
                 and (self.axis is None or self.axis in r.axes)]
        count = resolve(self.count, params)
        violations = []
        if len(found) != count:
            payload = f" with payload {tuple(shape)}" if shape is not None else ""
            axis = f" on axis '{self.axis}'" if self.axis is not None else ""
            violations.append(Violation(
                self.describe(),
                f"found {len(found)} `{self.prim}`{payload}{axis}, expected exactly {count}",
                tuple(_record_site(r) for r in found)))
        if self.dtype is not None:
            bad = [r for r in found if r.dtype != self.dtype]
            if bad:
                violations.append(Violation(
                    self.describe(),
                    f"`{self.prim}` payload dtype {sorted({r.dtype for r in bad})}, contract "
                    f"requires {self.dtype}", tuple(_record_site(r) for r in bad)))
        return violations


class AxisPayloadBits(NamedTuple):
    """Pin the total per-link bits all collectives move over one mesh axis.

    Sums, over every logical collective (``prims``) whose axes include
    ``axis``, the bits of its operand at its own dtype -- what one rank
    puts on the wire: a gather's operand is the rank's shard, a psum's
    the block the rank contributes.  A collective over several axes
    counts once, as the reference's trace holds it.
    """

    axis: str
    exact_bits: Optional[IntOrParam] = None
    max_bits: Optional[IntOrParam] = None
    prims: Tuple[str, ...] = ("psum", "all_gather")

    def describe(self) -> str:
        parts = []
        if self.exact_bits is not None:
            parts.append(f"=={self.exact_bits}")
        if self.max_bits is not None:
            parts.append(f"<={self.max_bits}")
        return f"payload_bits[axis={self.axis} {' '.join(parts) or 'any'}]"

    def check(self, counts, params=None) -> list:
        found = [r for r in counts.collectives if r.op in self.prims and self.axis in r.axes]
        total = sum(r.bits for r in found)
        sites = tuple(_record_site(r) for r in found)
        violations = []

        def fail(expected: str):
            violations.append(Violation(
                self.describe(),
                f"collectives over axis '{self.axis}' move {total} bits per link, expected "
                f"{expected}", sites))

        exact = resolve(self.exact_bits, params)
        if exact is not None and total != exact:
            fail(f"exactly {exact}")
        max_bits = resolve(self.max_bits, params)
        if max_bits is not None and total > max_bits:
            fail(f"at most {max_bits}")
        for op in self.prims:
            n = counts.unrecorded.get(op, 0)
            if n:
                violations.append(Violation(
                    self.describe(), f"{n} c10d {op} ran outside repro_torch.core.collectives: "
                    "their bits are not counted"))
        return violations


class SmemConformance(NamedTuple):
    """Cross-check the fused ADMM calls against the Hopper launch plan.

    For every K2/K3 call (``ops.CALL_BLOCKS``: d, k and the columns
    per block it used) ``block_k`` must not exceed what
    :func:`~repro_torch.kernels.dantzig_fused.plan_launch` allows within
    ``budget`` (None: ``SMEM_BYTES``, 227 KiB), and the block of the
    call's own columns, on the template the plan picks, must fit
    ``budget`` (``LaunchPlan.smem_bytes``, a cluster block's static
    shared memory added).  On the card the kernel's own report must
    match the plan (:func:`~repro_torch.kernels.dantzig_fused.check_on_card`)
    and fit the device's opt-in limit per block.
    """

    budget: Optional[IntOrParam] = None

    def describe(self) -> str:
        budget = self.budget if self.budget is not None else "SMEM_BYTES"
        return f"smem[_fused_admm <= {budget}]"

    def check(self, counts, params=None) -> list:
        from repro_torch.kernels import dantzig_fused as df

        budget = resolve(self.budget, params)
        if budget is None:
            budget = df.SMEM_BYTES
        optin = (torch.cuda.get_device_properties(torch.cuda.current_device())
                 .shared_memory_per_block_optin if counts.on_card else None)
        violations = []
        for (name, d, k, bk), n in sorted(counts.call_blocks.items()):
            state_io = name == "dantzig_fused_state"
            site = (f"{name}(d={d}, k={k}, block_k={bk}) x{n}",)

            def fail(msg):
                violations.append(Violation(self.describe(), msg, site))

            allowed = df.plan_launch(d, k, state_io=state_io, budget=budget).block_k
            if bk > allowed:
                fail(f"block_k={bk} exceeds plan_launch's choice {allowed} for (d={d}, k={k})")
            # one block of the call's own columns, with no budget to cap them
            plan = df.plan_launch(d, bk, bk, state_io, budget=float("inf"))
            used = plan.smem_bytes + (0 if plan.streamed else df.CLUSTER_STATIC_SMEM_BYTES)
            template = "streamed" if plan.streamed else f"cluster of {plan.cluster}"
            if used > budget:
                fail(f"the {template} block (d={d}, W={plan.width}) needs {used} bytes, budget "
                     f"is {budget}")
            if optin is None:
                continue
            if not plan.streamed:
                for msg in df.check_on_card(d, plan, state_io)[1]:
                    fail(msg)
            if used > optin:
                fail(f"the {template} block needs {used} bytes, over the card's opt-in limit "
                     f"of {optin}")
        return violations


class DtypePolicy(NamedTuple):
    """No float wider than ``max_float`` anywhere in the call: counts every op whose result
    holds a floating tensor wider than the ceiling."""

    max_float: str = "float32"

    def describe(self) -> str:
        return f"dtype[float <= {self.max_float}]"

    def check(self, counts, params=None) -> list:
        ceiling = torch.finfo(getattr(torch, self.max_float)).bits
        bad = {dt: n for dt, n in counts.float_outputs.items()
               if torch.finfo(getattr(torch, dt)).bits > ceiling}
        if not bad:
            return []
        return [Violation(self.describe(),
                          f"{sum(bad.values())} ops produce {sorted(bad)}, wider than the "
                          f"{self.max_float} ceiling",
                          tuple(f"{dt} x{n}" for dt, n in sorted(bad.items())))]


ContractType = Union[PrimitiveBudget, GramLaunches, CollectiveContract, AxisPayloadBits,
                     SmemConformance, DtypePolicy]


def run_contracts(contracts, counts, params: Optional[dict] = None) -> list:
    """Check every contract; a missing case param is itself a violation."""
    violations: list[Violation] = []
    for contract in contracts:
        try:
            violations.extend(contract.check(counts, params))
        except MissingParam as exc:
            violations.append(Violation(
                contract.describe(),
                f"case params missing key {exc.args[0]!r} needed by this contract"))
    return violations


def render_report(violations, indent: str = "  ") -> str:
    return "\n".join(indent + line for v in violations for line in v.render().splitlines())


__all__ = [
    "AxisPayloadBits",
    "CollectiveContract",
    "ContractType",
    "DtypePolicy",
    "GramLaunches",
    "MissingParam",
    "Param",
    "PrimitiveBudget",
    "SmemConformance",
    "Violation",
    "render_report",
    "resolve",
    "run_contracts",
]
