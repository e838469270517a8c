"""Analytic FLOP/byte accounting by walking a program's jaxpr.

XLA's compiled cost model is unusable for this repo's roofline: it counts
a `lax.scan` body ONCE regardless of trip count (measured here: identical
flops for batch 4 vs 16), and Pallas custom calls are fully opaque to it.
This walker instead traverses the jaxpr recursively and multiplies:

  - `scan` bodies by their static `length`,
  - `pallas_call` bodies by the grid size (the kernel jaxpr is available
    in the primitive's params — nothing is opaque at the jaxpr level),
  - `while_loop` bodies are data-dependent: counted ONCE, and additionally
    reported as (per_trip_flops, multiplier) entries so the caller can
    close the loop with a measured trip count (tools/roofline.py does this
    for the mandelbrot escape kernel from the measured iteration map).

Three op classes are kept separate because they cost differently:
  alu   — single-pass elementwise ops (add/mul/select/compare/...)
  eup   — transcendentals (exp/log/sqrt/sin/...; multi-instruction
          sequences, several x slower than ALU ops)
  mxu   — dot_general / conv FLOPs (2*M*N*K), the matrix units' domain

Byte accounting is an analytic HBM floor: top-level program inputs +
outputs, plus every pallas_call's full operand/result sizes (each kernel
reads its operands from device memory once per launch). XLA-fused intermediates
between kernels are not modeled — the result is a LOWER bound on traffic.

Verified against hand counts in tests/test_flopcount.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


# Elementwise primitives: 1 ALU op per output element.
ALU = {
    "add", "sub", "mul", "div", "rem", "max", "min", "neg", "abs", "sign",
    "floor", "ceil", "round", "and", "or", "xor", "not", "shift_left",
    "shift_right_logical", "shift_right_arithmetic", "eq", "ne", "lt", "le",
    "gt", "ge", "select_n", "clamp", "nextafter", "is_finite", "copy",
    "real", "imag", "conj", "population_count", "clz", "add_any",
}
# Transcendentals: EUP multi-pass ops, one per output element.
EUP = {
    "exp", "exp2", "log", "log1p", "expm1", "sin", "cos", "tan", "asin",
    "acos", "atan", "atan2", "sinh", "cosh", "tanh", "asinh", "acosh",
    "atanh", "sqrt", "rsqrt", "cbrt", "pow", "erf", "erfc", "erf_inv",
    "logistic", "digamma", "lgamma", "regularized_incomplete_beta",
    "integer_pow",
}
# Reductions: 1 ALU op per INPUT element.
REDUCE = {
    "reduce_sum", "reduce_prod", "reduce_max", "reduce_min", "reduce_and",
    "reduce_or", "reduce_xor", "argmax", "argmin", "cumsum", "cumprod",
    "cummax", "cummin", "reduce_precision",
}
# Shape/layout/indexing: 0 FLOPs.
FREE = {
    "reshape", "broadcast_in_dim", "transpose", "squeeze", "concatenate",
    "slice", "dynamic_slice", "dynamic_update_slice", "gather", "scatter",
    "scatter-add", "rev", "pad", "iota", "convert_element_type",
    "bitcast_convert_type", "stop_gradient", "copy_start", "copy_done",
    "device_put", "split", "pjit_forwarding", "squeeze_p", "expand_dims",
}


def _size(aval) -> int:
    shape = getattr(aval, "shape", ())
    return int(math.prod(shape)) if shape else 1


def _bytes(aval) -> int:
    dtype = getattr(aval, "dtype", None)
    itemsize = getattr(dtype, "itemsize", 4)
    return _size(aval) * itemsize


@dataclass
class Cost:
    alu: float = 0.0
    eup: float = 0.0
    mxu: float = 0.0
    pallas_bytes: float = 0.0      # full operand+result traffic of kernels
    io_bytes: float = 0.0          # top-level program inputs + outputs
    # Data-dependent while loops: (label, per_trip_flops, outer_multiplier).
    # Body flops are ALSO included in alu/eup once (one guaranteed trip).
    unknown_whiles: list = field(default_factory=list)

    @property
    def flops(self) -> float:
        return self.alu + self.eup + self.mxu

    def add(self, other: "Cost") -> None:
        self.alu += other.alu
        self.eup += other.eup
        self.mxu += other.mxu
        self.pallas_bytes += other.pallas_bytes
        self.unknown_whiles.extend(other.unknown_whiles)

    def scaled(self, k: float) -> "Cost":
        return Cost(self.alu * k, self.eup * k, self.mxu * k,
                    self.pallas_bytes * k, self.io_bytes * k,
                    [(n, f, m * k) for n, f, m in self.unknown_whiles])


def _dot_flops(eqn) -> float:
    (contract, _batch) = eqn.params["dimension_numbers"]
    lhs_contract = contract[0]
    lhs = eqn.invars[0].aval
    k = math.prod(lhs.shape[d] for d in lhs_contract) or 1
    out = _size(eqn.outvars[0].aval)
    return 2.0 * out * k


def _conv_flops(eqn) -> float:
    rhs = eqn.invars[1].aval          # kernel
    dn = eqn.params["dimension_numbers"]
    spatial = math.prod(rhs.shape[d] for d in dn.rhs_spec[2:]) or 1
    in_ch = rhs.shape[dn.rhs_spec[1]]
    groups = eqn.params.get("feature_group_count", 1) or 1
    out = _size(eqn.outvars[0].aval)
    return 2.0 * out * spatial * in_ch / groups


def _inner(jaxpr):
    """Unwrap ClosedJaxpr -> Jaxpr."""
    return getattr(jaxpr, "jaxpr", jaxpr)


def count_jaxpr(jaxpr) -> Cost:
    """Recursive cost of one execution of `jaxpr` (Jaxpr or ClosedJaxpr)."""
    jaxpr = _inner(jaxpr)
    total = Cost()
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        out0 = eqn.outvars[0].aval if eqn.outvars else None
        if name in FREE:
            continue
        if name in ALU:
            total.alu += _size(out0)
        elif name in EUP:
            total.eup += _size(out0)
        elif name in REDUCE:
            total.alu += _size(eqn.invars[0].aval)
        elif name == "dot_general":
            total.mxu += _dot_flops(eqn)
        elif name == "conv_general_dilated":
            total.mxu += _conv_flops(eqn)
        elif name == "scan":
            body = count_jaxpr(eqn.params["jaxpr"])
            total.add(body.scaled(float(eqn.params["length"])))
        elif name == "while":
            body = count_jaxpr(eqn.params["body_jaxpr"])
            cond = count_jaxpr(eqn.params["cond_jaxpr"])
            per_trip = body.flops + cond.flops
            total.add(body)           # one guaranteed trip
            total.add(cond)
            total.unknown_whiles.append(("while", per_trip, 1.0))
        elif name == "cond":
            branches = [count_jaxpr(b) for b in eqn.params["branches"]]
            if branches:
                total.add(max(branches, key=lambda c: c.flops))
        elif name == "pallas_call":
            gm = eqn.params.get("grid_mapping")
            grid = getattr(gm, "grid", ()) or ()
            launches = float(math.prod(grid)) if grid else 1.0
            body = count_jaxpr(eqn.params["jaxpr"])
            total.add(body.scaled(launches))
            # HBM floor: each grid step streams one BLOCK of every
            # operand/result through VMEM. Counting full array sizes
            # instead overcounts operands whose index_map pins most dims
            # (e.g. the per-frame slice of a whole-batch prelude stack:
            # measured 2.36 GB/frame "traffic" = 486% of HBM peak).
            bms = list(getattr(gm, "block_mappings", ()) or ())
            nidx = int(getattr(gm, "num_index_operands", 0) or 0)
            operands = list(eqn.invars)[nidx:] + list(eqn.outvars)
            if bms and len(bms) <= len(operands):
                for bm, v in zip(bms, operands):
                    shape = []
                    for e in getattr(bm, "block_shape", ()) or ():
                        size = getattr(e, "block_size", None)
                        shape.append(int(size) if size is not None
                                     else int(e) if isinstance(e, int) else 1)
                    dtype = getattr(getattr(v, "aval", None), "dtype", None)
                    itemsize = getattr(dtype, "itemsize", 4)
                    total.pallas_bytes += (math.prod(shape) if shape else 1) \
                        * itemsize * launches
            else:
                for v in list(eqn.invars) + list(eqn.outvars):
                    total.pallas_bytes += _bytes(v.aval)
        else:
            inner = None
            for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                if key in eqn.params:
                    inner = eqn.params[key]
                    break
            if inner is not None:
                total.add(count_jaxpr(inner))
            # Unknown leaf primitives (rng, sort, fft, ...) count 0 — the
            # walker is a floor, and none of them appear in render programs
    return total


def count_fn(fn, *args, **kwargs) -> Cost:
    """Cost of `fn(*args)` plus the top-level I/O byte floor."""
    import jax
    closed = jax.make_jaxpr(fn, **kwargs)(*args)
    cost = count_jaxpr(closed)
    jaxpr = _inner(closed)
    for v in list(jaxpr.invars) + list(jaxpr.outvars):
        cost.io_bytes += _bytes(v.aval)
    return cost
