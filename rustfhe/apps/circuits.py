"""Boolean circuits over encrypted bits, evaluated level-by-level in batches.

This is new batch-first capability beyond the reference (which evaluates one
gate at a time, ``nander/src/lib.rs:72-89``): a circuit is levelized into
topological layers, and within each layer all gates of the same type run as
ONE batched bootstrapping call — the batch axis is where device throughput
comes from (SURVEY.md §7).

Includes the 8-bit ripple-carry adder depth test from BASELINE.json's
bench configs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32

# gate ops: 2-input ops plus NOT and MUX


@dataclass
class Gate:
    op: str  # nand|and|or|xor|not|mux
    inputs: tuple[int, ...]
    output: int


@dataclass
class Circuit:
    """Wire-indexed gate list.  Wires [0, n_inputs) are primary inputs."""

    n_inputs: int
    gates: list[Gate] = field(default_factory=list)
    outputs: list[int] = field(default_factory=list)
    _next: int = None  # type: ignore

    def __post_init__(self):
        if self._next is None:
            self._next = self.n_inputs

    def _new_wire(self) -> int:
        w = self._next
        self._next += 1
        return w

    def add(self, op: str, *inputs: int) -> int:
        out = self._new_wire()
        self.gates.append(Gate(op, tuple(inputs), out))
        return out

    def nand(self, a, b):
        return self.add("nand", a, b)

    def and_(self, a, b):
        return self.add("and", a, b)

    def or_(self, a, b):
        return self.add("or", a, b)

    def xor(self, a, b):
        return self.add("xor", a, b)

    def not_(self, a):
        return self.add("not", a)

    def mux(self, control, in0, in1):
        return self.add("mux", control, in0, in1)

    @property
    def n_wires(self) -> int:
        return self._next

    def levelize(self) -> list[list[Gate]]:
        """Topological layers: a gate's level = 1 + max(level of inputs)."""
        level = {w: 0 for w in range(self.n_inputs)}
        layers: dict[int, list[Gate]] = {}
        for g in self.gates:
            lv = 1 + max((level.get(w, 0) for w in g.inputs), default=0)
            level[g.output] = lv
            layers.setdefault(lv, []).append(g)
        return [layers[k] for k in sorted(layers)]

    @property
    def depth(self) -> int:
        return len(self.levelize())


_COMMUTATIVE = {"and", "or", "xor", "nand"}


def optimize(circuit: Circuit) -> Circuit:
    """Exact gate-count reduction: common-subexpression elimination +
    dead-gate elimination.

    Every gate in this framework costs one bootstrap LANE per batch
    element (the level-fused evaluator below), so duplicate or unused
    gates are pure wasted bootstrap work.  Two passes, both
    semantics-preserving bit-for-bit (tests/test_optimize.py asserts
    plain- and encrypted-evaluation equivalence):

    * CSE — value numbering over the gate DAG: a gate whose
      (op, canonical inputs) was already computed reuses the earlier
      output wire; commutative 2-input ops (and/or/xor/nand) canonicalize
      their operand order first.
    * DCE — a backward reachability sweep from ``outputs`` drops gates
      whose result feeds nothing (e.g. the prefix scan's last-stage P
      windows in ``prefix_comparator``: 30 of its 67 gates die).

    Wire numbering is compacted; input wires [0, n_inputs) and the
    output LIST are preserved (an output may map to an input wire).
    Depth never increases (CSE merges into the EARLIER gate; DCE only
    removes).  The pass is idempotent and O(gates).

    The reference evaluates one gate at a time with no circuit layer at
    all (``nander/src/lib.rs:72-89``); this optimizer is part of the
    beyond-reference circuit compiler (levelizer + optimizer + fused
    batched evaluation).
    """
    rep: dict[int, int] = {w: w for w in range(circuit.n_inputs)}
    seen: dict[tuple, int] = {}
    kept: list[Gate] = []  # gates with canonicalized input wires
    for g in circuit.gates:
        ins = tuple(rep[w] for w in g.inputs)
        if g.op in _COMMUTATIVE:
            ins = tuple(sorted(ins))
        key = (g.op, ins)
        if key in seen:
            rep[g.output] = seen[key]
        else:
            seen[key] = rep[g.output] = g.output
            kept.append(Gate(g.op, ins, g.output))
    # DCE: backward sweep (kept is topologically ordered).
    needed = {rep[o] for o in circuit.outputs}
    live: list[Gate] = []
    for g in reversed(kept):
        if g.output in needed:
            live.append(g)
            needed.update(g.inputs)
    live.reverse()
    # Compact wire ids: inputs keep theirs, live gate outputs renumber.
    new_id = {w: w for w in range(circuit.n_inputs)}
    out = Circuit(n_inputs=circuit.n_inputs)
    for g in live:
        new_id[g.output] = out.add(g.op, *(new_id[w] for w in g.inputs))
    out.outputs = [new_id[rep[o]] for o in circuit.outputs]
    return out


def evaluate_plain(circuit: Circuit, inputs: np.ndarray) -> np.ndarray:
    """Plaintext evaluation; inputs (..., n_inputs) -> (..., n_outputs)."""
    inputs = np.asarray(inputs)
    wires = {w: inputs[..., w] for w in range(circuit.n_inputs)}
    for g in circuit.gates:
        a = [wires[w] for w in g.inputs]
        if g.op == "nand":
            wires[g.output] = 1 - (a[0] & a[1])
        elif g.op == "and":
            wires[g.output] = a[0] & a[1]
        elif g.op == "or":
            wires[g.output] = a[0] | a[1]
        elif g.op == "xor":
            wires[g.output] = a[0] ^ a[1]
        elif g.op == "not":
            wires[g.output] = 1 - a[0]
        elif g.op == "mux":
            wires[g.output] = np.where(a[0] != 0, a[2], a[1])
        else:
            raise ValueError(g.op)
    return np.stack([wires[w] for w in circuit.outputs], axis=-1)


def _bucket(k: int) -> int:
    """Round a per-level gate count up so jitted bootstrap programs are
    reused across levels: powers of two up to 256, then multiples of 256
    (bounded padding waste on wide levels, bounded compile count)."""
    if k <= 1:
        return 1
    if k <= 256:
        return 1 << (k - 1).bit_length()
    return ((k + 255) // 256) * 256


# Every primitive gate's pre-combination is linear in (x, y, mu):
# pre = ca*x + cb*y + cm*mu (mod 2^32), followed by the SAME bootstrap
# (reference formulas tfhe.rs:27-71).  Canonical table lives in
# gates.PRE_COEFFS; re-exported here under the historical name.
from ..gates import PRE_COEFFS as _COEFFS  # noqa: E402


def lower(circuit: Circuit):
    """Lower to linear-precombination primitives: mux(c, in0, in1) becomes
    and(c, in1), andn(c, in0), or(.., ..) (the reference's 3-bootstrap
    decomposition, tfhe.rs:29-39).  Returns (ops, in_a, in_b, out, n_wires)
    as numpy arrays over primitive gate indices."""
    ops, in_a, in_b, outs = [], [], [], []
    next_wire = circuit.n_wires
    for g in circuit.gates:
        if g.op == "mux":
            c, i0, i1 = g.inputs
            w1, w2 = next_wire, next_wire + 1
            next_wire += 2
            ops += ["and", "andn", "or"]
            in_a += [c, c, w1]
            in_b += [i1, i0, w2]
            outs += [w1, w2, g.output]
        elif g.op == "not":
            ops.append("not")
            in_a.append(g.inputs[0])
            in_b.append(g.inputs[0])  # unused (cb = 0)
            outs.append(g.output)
        else:
            ops.append(g.op)
            in_a.append(g.inputs[0])
            in_b.append(g.inputs[1])
            outs.append(g.output)
    return (
        np.array(ops),
        np.array(in_a, np.int64),
        np.array(in_b, np.int64),
        np.array(outs, np.int64),
        next_wire,
    )


def lower_folded(circuit: Circuit):
    """``lower`` + NOT elimination.

    NOT is FREE in TFHE: the binary encoding is ±mu, so enc(!b) is exactly
    ``tlwe.neg(enc(b))`` — an elementwise wrapping negation, no bootstrap
    (the reference's gate-level ``hom_not`` still bootstraps for API
    parity with ``tfhe.rs:66-71``; inside a CIRCUIT the refresh is
    pointless, because every consumer's pre-combination is linear).  A
    ``not`` gate therefore costs neither a bootstrap lane nor a level:

      * each consumer flips the sign of the corresponding coefficient
        (``ca*(-x) = (-ca)*x`` mod 2^32) — noise magnitude is unchanged,
        so gate margins are identical;
      * NOT chains collapse (!!x = x);
      * a negated circuit OUTPUT is one elementwise negation at
        extraction (``evaluate_encrypted`` applies it in-program).

    mux lowers to and/andn/or as in ``lower``.  Returns
    ``(coeffs (G, 3) int64, in_a, in_b, out_w, n_wires,
    out_src (n_outputs,) int64, out_neg (n_outputs,) bool)`` over the
    EMITTED (non-NOT) gates; an all-NOT circuit emits zero gates.
    """
    src = {w: (w, False) for w in range(circuit.n_inputs)}
    coeffs, in_a, in_b, outs = [], [], [], []
    next_wire = circuit.n_wires

    def emit(op, a, b, out):
        aw, an = src.get(a, (a, False))
        bw, bn = src.get(b, (b, False))
        ca, cb, cm = _COEFFS[op]
        coeffs.append((-ca if an else ca, -cb if bn else cb, cm))
        in_a.append(aw)
        in_b.append(bw)
        outs.append(out)
        src[out] = (out, False)

    for g in circuit.gates:
        if g.op == "not":
            w, n = src.get(g.inputs[0], (g.inputs[0], False))
            src[g.output] = (w, not n)
        elif g.op == "mux":
            c, i0, i1 = g.inputs
            w1, w2 = next_wire, next_wire + 1
            next_wire += 2
            emit("and", c, i1, w1)
            emit("andn", c, i0, w2)
            emit("or", w1, w2, g.output)
        else:
            emit(g.op, g.inputs[0], g.inputs[1], g.output)

    out_src = [src.get(o, (o, False)) for o in circuit.outputs]
    return (
        np.array(coeffs, np.int64).reshape(-1, 3),
        np.array(in_a, np.int64),
        np.array(in_b, np.int64),
        np.array(outs, np.int64),
        next_wire,
        np.array([w for w, _ in out_src], np.int64),
        np.array([n for _, n in out_src], bool),
    )


def evaluate_encrypted(circuit: Circuit, ctx, ct_inputs,
                       fixed_width: int | None = None) -> jnp.ndarray:
    """Level-fused batched FHE evaluation.

    ``ct_inputs``: TLWE batch of shape (n_inputs, n+1) (or (..., n_inputs,
    n+1) with extra leading batch axes — every gate then evaluates the whole
    leading batch too).

    Design (scales to >=10k-gate circuits):
      * the circuit is lowered to linear-precombination primitives and
        levelized by the NATIVE levelizer (native/negacyclic.cpp) — host
        scheduling cost is O(gates) in C++, not Python;
      * all wires live in ONE device array (n_wires, ..., n+1); per level the
        inputs are two indexed gathers and the outputs one scatter;
      * a level runs as ONE batched bootstrap for ALL its gates regardless of
        op (the per-gate op is a (ca, cb, cm) coefficient triple applied
        vectorized), padded only to the level's width bucket — per-level
        dispatch cost is independent of gate count, and there are no per-op
        dummy-lane bootstraps.

    ``fixed_width``: pad every level to exactly this width (must be >= the
    widest level) so ONE compiled bootstrap program serves every level —
    used where compiles are expensive (each new width compiles the n-step
    scan again).
    """
    from .. import native

    circuit = optimize(circuit)  # exact CSE+DCE: fewer bootstrap lanes
    coeff, in_a, in_b, out_w, n_wires, out_src, out_neg = lower_folded(circuit)
    n_gates = len(out_w)
    if n_gates:
        inputs3 = np.stack([in_a, in_b, np.full(n_gates, -1, np.int64)], axis=1)
        levels, depth = native.levelize(
            n_gates, n_wires, circuit.n_inputs, inputs3, out_w)
    else:  # all-NOT / pass-through circuit: no bootstraps at all
        levels, depth = np.zeros(0, np.int64), 0

    coeff = coeff & 0xFFFFFFFF  # (G, 3) folded signs, mod 2^32

    # Wire-major storage: (n_wires, ..., n+1).
    ct_inputs = jnp.asarray(ct_inputs, U32)
    lead = ct_inputs.shape[:-2]
    n1 = ct_inputs.shape[-1]
    wires = jnp.zeros((n_wires,) + lead + (n1,), U32)
    wires = wires.at[: circuit.n_inputs].set(
        jnp.moveaxis(ct_inputs, -2, 0).reshape((circuit.n_inputs,) + lead + (n1,))
    )
    bshape = (-1,) + (1,) * (len(lead) + 1)
    p = ctx.params

    for lv in range(1, depth + 1):
        sel = np.nonzero(levels == lv)[0]
        k = len(sel)
        width = fixed_width if fixed_width is not None else _bucket(k)
        assert width >= k, (width, k)
        pad = width - k
        idx_a = np.concatenate([in_a[sel], np.zeros(pad, np.int64)])
        idx_b = np.concatenate([in_b[sel], np.zeros(pad, np.int64)])
        cs = np.concatenate([coeff[sel], np.zeros((pad, 3), np.int64)])
        ca = jnp.asarray(cs[:, 0], U32).reshape(bshape)
        cb = jnp.asarray(cs[:, 1], U32).reshape(bshape)
        cm = jnp.asarray((cs[:, 2] * p.mu) & 0xFFFFFFFF, U32)  # (k+pad,)
        xa = wires[jnp.asarray(idx_a)]  # (k+pad, ..., n+1)
        xb = wires[jnp.asarray(idx_b)]
        pre = (xa * ca + xb * cb).astype(U32)
        pre = pre.at[(slice(None),) + (slice(None),) * len(lead) + (0,)].add(
            cm.reshape((-1,) + (1,) * len(lead))
        )
        outs = ctx.bootstrap_raw(pre)
        wires = wires.at[jnp.asarray(out_w[sel])].set(outs[:k])
    result = wires[jnp.asarray(out_src)]
    if out_neg.any():  # negated outputs: free elementwise tlwe.neg
        mask = jnp.asarray(out_neg).reshape((-1,) + (1,) * (len(lead) + 1))
        result = jnp.where(mask, (U32(0) - result).astype(U32), result)
    return jnp.moveaxis(result, 0, -2)


def ripple_borrow_subtractor(n_bits: int) -> Circuit:
    """n-bit ripple-borrow subtractor a - b: inputs a[0..n), b[0..n)
    (LSB first); outputs diff[0..n) then borrow-out (1 iff a < b).
    Full subtractor per bit: d = a^b^bin,
    bout = (~a & b) | (~(a^b) & bin)."""
    c = Circuit(n_inputs=2 * n_bits)
    borrow = None
    diffs = []
    for i in range(n_bits):
        a, b = i, n_bits + i
        axb = c.xor(a, b)
        if borrow is None:
            diffs.append(axb)
            borrow = c.and_(c.not_(a), b)
        else:
            diffs.append(c.xor(axb, borrow))
            t1 = c.and_(c.not_(a), b)
            t2 = c.and_(c.not_(axb), borrow)
            borrow = c.or_(t1, t2)
    c.outputs = diffs + [borrow]
    return c


def comparator(n_bits: int) -> Circuit:
    """n-bit unsigned comparator: inputs a[0..n), b[0..n) (LSB first);
    outputs [lt, eq, gt].  lt = borrow-out of a - b; eq = AND-tree over
    per-bit XNORs; gt = ~(lt | eq)."""
    c = Circuit(n_inputs=2 * n_bits)
    borrow = None
    eqs = []
    for i in range(n_bits):
        a, b = i, n_bits + i
        axb = c.xor(a, b)
        eqs.append(c.not_(axb))
        if borrow is None:
            borrow = c.and_(c.not_(a), b)
        else:
            t1 = c.and_(c.not_(a), b)
            t2 = c.and_(c.not_(axb), borrow)
            borrow = c.or_(t1, t2)
    # Balanced AND-tree keeps the equality depth logarithmic.
    while len(eqs) > 1:
        eqs = [
            c.and_(eqs[j], eqs[j + 1]) if j + 1 < len(eqs) else eqs[j]
            for j in range(0, len(eqs), 2)
        ]
    eq = eqs[0]
    gt = c.not_(c.or_(borrow, eq))
    c.outputs = [borrow, eq, gt]
    return c


def _ripple_add_bits(c: Circuit, xs: list, ys: list) -> list:
    """Add two LSB-first wire lists of (possibly) unequal length; returns
    the sum bits with the final carry appended (no constant wires needed:
    absent high bits are treated as 0 by degrading full adders to half
    adders)."""
    out = []
    carry = None
    for i in range(max(len(xs), len(ys))):
        x = xs[i] if i < len(xs) else None
        y = ys[i] if i < len(ys) else None
        if x is None:
            x, y = y, None
        if y is None:
            if carry is None:
                out.append(x)
            else:
                out.append(c.xor(x, carry))
                carry = c.and_(x, carry)
        else:
            axb = c.xor(x, y)
            if carry is None:
                out.append(axb)
                carry = c.and_(x, y)
            else:
                out.append(c.xor(axb, carry))
                carry = c.or_(c.and_(x, y), c.and_(carry, axb))
    if carry is not None:
        out.append(carry)
    return out


def wallace_multiplier(n_bits: int) -> Circuit:
    """Log-depth n x n -> 2n unsigned multiplier: partial products (one
    AND level), carry-save 3:2 compression (each layer 3 levels: the
    full-adder's xor/xor + and/and/or), then one parallel-prefix add.

    Depth for n=8: 30 levels vs the array multiplier's 40 (carry chains
    couple consecutive 3:2 layers, so a layer costs ~3 levels plus the
    carries' column skew; ``Circuit.depth`` is the measured source of
    truth) — the
    latency-right bit-world multiplier on the level-fused evaluator
    (VERDICT r3 item 6; the radix path, radix.py, is cheaper still when
    PBS-tuned parameters are available)."""
    assert n_bits >= 2
    c = Circuit(n_inputs=2 * n_bits)
    cols = [[] for _ in range(2 * n_bits)]
    for i in range(n_bits):
        for j in range(n_bits):
            cols[i + j].append(c.and_(j, n_bits + i))
    # 3:2 compression until every column holds <= 2 bits.
    while any(len(col) > 2 for col in cols):
        ncols = [[] for _ in range(2 * n_bits)]
        for k, col in enumerate(cols):
            i = 0
            while len(col) - i >= 3:
                a, b, cc = col[i : i + 3]
                i += 3
                axb = c.xor(a, b)
                ncols[k].append(c.xor(axb, cc))
                carry = c.or_(c.and_(a, b), c.and_(cc, axb))
                if k + 1 < 2 * n_bits:
                    ncols[k + 1].append(carry)
            ncols[k].extend(col[i:])
        cols = ncols
    xs = [col[0] if len(col) >= 1 else None for col in cols]
    ys = [col[1] if len(col) >= 2 else None for col in cols]
    sums, _cout = _prefix_add(c, xs, ys)
    c.outputs = sums[: 2 * n_bits]
    return c


def array_multiplier(n_bits: int) -> Circuit:
    """n x n -> 2n unsigned array multiplier (shift-add): inputs a[0..n),
    b[0..n) (LSB first); outputs prod[0..2n).  Row i of partial products
    a[j] & b[i] is ripple-added into the accumulator at offset i — the
    textbook array structure, so every row is one batched AND level plus
    adder levels under the level-fused evaluator.  Requires n_bits >= 2
    (the 1x1 product has a constant-zero high bit, and circuits carry no
    constant wires)."""
    assert n_bits >= 2, "array_multiplier needs n_bits >= 2"
    c = Circuit(n_inputs=2 * n_bits)
    acc = [c.and_(j, n_bits + 0) for j in range(n_bits)]  # pp row 0
    for i in range(1, n_bits):
        pp = [c.and_(j, n_bits + i) for j in range(n_bits)]
        acc = acc[:i] + _ripple_add_bits(c, acc[i:], pp)
    assert len(acc) == 2 * n_bits, len(acc)
    c.outputs = acc
    return c


def _prefix_scan(c: Circuit, p: list, g: list) -> list:
    """Kogge-Stone parallel-prefix over (propagate, generate) wire lists;
    returns the full-window G list (G[i] = carry out of position i).
    Depth 2*ceil(log2 n) on top of the inputs."""
    n = len(p)
    P, G = list(p), list(g)
    s = 1
    while s < n:
        nG, nP = list(G), list(P)
        for i in range(n - 1, s - 1, -1):
            t = c.and_(P[i], G[i - s])
            nG[i] = c.or_(G[i], t)
            if i - s >= s:  # P only needed while windows keep growing
                nP[i] = c.and_(P[i], P[i - s])
        G, P = nG, nP
        s *= 2
    return G


def _prefix_add(c: Circuit, xs: list, ys: list, incoming_one: bool = False):
    """Log-depth add of two wire lists inside an existing circuit;
    ``None`` entries mean a constant-0 bit on that side.  Returns
    (sum wires, carry-out wire or None).  Bit 0's sum is emitted RAW when
    ``incoming_one`` (see kogge_stone_adder)."""
    n = max(len(xs), len(ys))
    xs = list(xs) + [None] * (n - len(xs))
    ys = list(ys) + [None] * (n - len(ys))
    # Pair holes: ensure x side is the non-None one where possible.
    for i in range(n):
        if xs[i] is None:
            xs[i], ys[i] = ys[i], None
    zero = None

    def need_zero():
        nonlocal zero
        if zero is None:
            w = next(w for w in xs if w is not None)
            zero = c.xor(w, w)  # constant 0 from any wire
        return zero

    p, g = [], []
    for i in range(n):
        if xs[i] is None:  # both missing
            p.append(need_zero())
            g.append(need_zero())
        elif ys[i] is None:  # one operand: propagate = the bit, generate 0
            p.append(xs[i])
            g.append(need_zero())
        else:
            p.append(c.xor(xs[i], ys[i]))
            g.append(c.and_(xs[i], ys[i]))
    if incoming_one:
        assert xs[0] is not None and ys[0] is not None
        g[0] = c.or_(xs[0], ys[0])
    G = _prefix_scan(c, p, g)
    sums = [p[0]] + [c.xor(p[i], G[i - 1]) for i in range(1, n)]
    return sums, G[n - 1]


def kogge_stone_adder(n_bits: int, incoming_one: bool = False) -> Circuit:
    """Log-depth parallel-prefix (Kogge-Stone) adder: inputs a[0..n),
    b[0..n) (LSB first); outputs sum[0..n) then carry-out.

    Depth 1 + 2*ceil(log2 n) levels (n=8: SEVEN levels vs the ripple
    adder's 15) at ~2x the gate count — the right trade on this framework,
    where a level is ONE batched bootstrap whose cost is nearly
    width-independent at interactive batch sizes (apps/circuits.py
    level-fused evaluator; VERDICT r3 item 6).

    ``incoming_one``: compute ``a + b + 1`` with the +1 folded into the
    LSB cell (g_0 = a_0 | b_0 — same depth), for two's-complement
    subtraction with pre-negated ``b``.  In this mode output bit 0 is
    emitted as the RAW xor ``a_0 ^ b_0`` (its true value is the
    complement); the caller negates that plane — a free linear op at the
    ciphertext layer (tlwe.neg), not a bootstrap.
    """
    c = Circuit(n_inputs=2 * n_bits)
    sums, cout = _prefix_add(
        c, list(range(n_bits)), list(range(n_bits, 2 * n_bits)),
        incoming_one=incoming_one)
    c.outputs = sums + [cout]
    return c


def prefix_comparator(n_bits: int) -> Circuit:
    """Log-depth comparator core: inputs a[0..n), b'[0..n) where b' is the
    BITWISE COMPLEMENT of b (a free plane negation at the ciphertext
    layer, not a gate); outputs [ge, eq]:

      * ``ge`` = carry-out of a + b' + 1 = a - b (1 iff a >= b); lt is its
        free negation;
      * ``eq`` = AND-tree over p_i = a_i ^ b'_i = xnor(a_i, b_i) — the
        same level-1 gates that feed the prefix scan, so the tree runs in
        parallel with it.

    Depth 1 + 2*ceil(log2 n) (n=8: 7 levels vs the ripple comparator's
    ~15).
    """
    c = Circuit(n_inputs=2 * n_bits)
    # p_i = a_i ^ b'_i = xnor(a_i, b_i): propagate for the subtract AND the
    # per-bit equality indicator, from the same level-1 gates.
    p = [c.xor(i, n_bits + i) for i in range(n_bits)]
    g = [c.or_(0, n_bits)] + [c.and_(i, n_bits + i) for i in range(1, n_bits)]
    G = _prefix_scan(c, p, g)
    # eq = AND-tree over the xnors p_i (balanced, log depth — runs in
    # parallel with the prefix scan's levels).
    eqs = list(p)
    while len(eqs) > 1:
        eqs = [
            c.and_(eqs[j], eqs[j + 1]) if j + 1 < len(eqs) else eqs[j]
            for j in range(0, len(eqs), 2)
        ]
    c.outputs = [G[n_bits - 1], eqs[0]]
    return c


def ripple_carry_adder(n_bits: int) -> Circuit:
    """n-bit ripple-carry adder: inputs a[0..n), b[0..n) (LSB first);
    outputs sum[0..n) then carry-out.  Full adder per bit:
    s = a^b^cin, cout = (a&b) | (cin & (a^b)) — emitted by the shared
    ``_ripple_add_bits`` (the multiplier's rows use the same structure,
    so adder- and multiplier-internal adds share bootstrap levels)."""
    c = Circuit(n_inputs=2 * n_bits)
    c.outputs = _ripple_add_bits(
        c, list(range(n_bits)), list(range(n_bits, 2 * n_bits))
    )
    return c
