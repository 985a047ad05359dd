"""Host-side tapes of the potentials' planar kernels, and their plain
PyTorch evaluator.

The fused log-potential kernel (K5, ``csrc/logpot_leapfrog.cu``) needs each
bucket's log-potential and its gradient in a form a CUDA kernel can run.
The reference traced ``jax.vjp`` of ``Potential.kernel_planar`` inside its
Pallas kernel; a CUDA kernel cannot trace Python, and MLN formulas are
arbitrary Python lambdas. So each bucket's planar function is run ONCE on
the host on proxy slots, which record every operation into a small
**tape**: a list of nodes in evaluation order, the last one being the
factor's log-potential. The kernel interprets the tape forward for the
value and backward (reverse-mode) for the continuous-slot adjoints;
:func:`tape_forward`/:func:`tape_reverse` are the same interpreter in
plain PyTorch, over ``[C, R]`` tensors (chains × factor rows).

Node ops (``OPS``): leaves ``const`` (value in ``c``), ``cont`` /
``disc`` (slot ``a`` of the factor's continuous / discrete arguments, in
pattern order) and ``param`` (row ``a`` of the bucket's flattened
parameter table); binary ``add sub mul div min max`` and the comparisons
``eq ne lt gt le ge`` (1.0/0.0, no gradient) over nodes ``a``, ``b``;
unary ``neg exp log abs`` and ``pow`` by the constant exponent ``c``.
These cover every formula of the repo's models. Anything else (another
torch function, a method call, Python control flow on a traced value)
raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

OPS = ("const", "cont", "disc", "param", "add", "sub", "mul", "div", "neg",
       "pow", "exp", "log", "abs", "min", "max", "eq", "ne", "lt", "gt",
       "le", "ge")
OP = {name: i for i, name in enumerate(OPS)}
MAX_NODES = 128  # the kernel's per-thread value/adjoint arrays
_LEAVES = ("const", "cont", "disc", "param")
_CMP = ("eq", "ne", "lt", "gt", "le", "ge")


@dataclasses.dataclass(frozen=True)
class Tape:
    """One bucket's traced log-potential: node ``i`` is ``ops[i]`` over
    nodes/leaf ids ``a[i]``, ``b[i]`` and constant ``c[i]``; ``grad[i]``
    says whether node ``i`` depends on a continuous slot (only those
    carry adjoints). The last node is the output."""

    ops: Tuple[str, ...]
    a: Tuple[int, ...]
    b: Tuple[int, ...]
    c: Tuple[float, ...]
    grad: Tuple[bool, ...]

    def __len__(self) -> int:
        return len(self.ops)

    def arrays(self):
        """(op code with the grad flag in bit 8, a, b) as int32 and c as
        f32 numpy arrays: the kernel's layout."""
        code = np.array([OP[o] | (int(g) << 8)
                         for o, g in zip(self.ops, self.grad)], np.int32)
        return (code, np.asarray(self.a, np.int32),
                np.asarray(self.b, np.int32), np.asarray(self.c, np.float32))


class _Recorder:
    def __init__(self):
        self.nodes: List[Tuple[str, int, int, float]] = []
        self._leaf: Dict[tuple, int] = {}

    def add(self, op: str, a: int = -1, b: int = -1, c: float = 0.0):
        if op in _LEAVES:  # one node per distinct leaf
            key = (op, a, float(np.float32(c)))
            if key not in self._leaf:
                self._leaf[key] = len(self.nodes)
                self.nodes.append((op, a, b, c))
            return _Node(self, self._leaf[key])
        self.nodes.append((op, a, b, c))
        return _Node(self, len(self.nodes) - 1)

    def index(self, v) -> int:
        """Node index of an operand (a traced value or a constant)."""
        if isinstance(v, _Node):
            if v.rec is not self:
                raise NotImplementedError("a value traced in another formula")
            return v.i
        if isinstance(v, torch.Tensor) and v.dim() == 0:
            v = float(v)
        if isinstance(v, (numbers.Real, np.number)):  # bools included
            return self.add("const", c=float(v)).i
        raise NotImplementedError(
            f"an operand of type {type(v).__name__} (the fused kernel takes "
            f"scalars per factor: slots, parameters and constants)")

    def binary(self, op, x, y):
        return self.add(op, self.index(x), self.index(y))

    def unary(self, op, x):
        return self.add(op, self.index(x))


# torch function (or Tensor method) name -> (op, operands swapped)
_TORCH_BINARY = {
    "add": ("add", False), "__add__": ("add", False), "__radd__": ("add", True),
    "sub": ("sub", False), "subtract": ("sub", False),
    "__sub__": ("sub", False), "__rsub__": ("sub", True),
    "mul": ("mul", False), "multiply": ("mul", False),
    "__mul__": ("mul", False), "__rmul__": ("mul", True),
    "div": ("div", False), "divide": ("div", False),
    "true_divide": ("div", False), "__truediv__": ("div", False),
    "__rtruediv__": ("div", True),
    "minimum": ("min", False), "maximum": ("max", False),
    "eq": ("eq", False), "__eq__": ("eq", False),
    "ne": ("ne", False), "__ne__": ("ne", False),
    "lt": ("lt", False), "__lt__": ("lt", False),
    "gt": ("gt", False), "__gt__": ("gt", False),
    "le": ("le", False), "__le__": ("le", False),
    "ge": ("ge", False), "__ge__": ("ge", False),
}
_TORCH_UNARY = {"exp": "exp", "log": "log", "abs": "abs", "__abs__": "abs",
                "neg": "neg", "negative": "neg", "__neg__": "neg"}


class _Node:
    """A traced per-(chain, factor) scalar. Arithmetic and the torch
    functions of the op set record nodes; everything else raises."""

    __slots__ = ("rec", "i")
    __array_ufunc__ = None  # numpy scalars defer to the reflected operator

    def __init__(self, rec: _Recorder, i: int):
        self.rec, self.i = rec, i

    def __add__(self, o): return self.rec.binary("add", self, o)
    def __radd__(self, o): return self.rec.binary("add", o, self)
    def __sub__(self, o): return self.rec.binary("sub", self, o)
    def __rsub__(self, o): return self.rec.binary("sub", o, self)
    def __mul__(self, o): return self.rec.binary("mul", self, o)
    def __rmul__(self, o): return self.rec.binary("mul", o, self)
    def __truediv__(self, o): return self.rec.binary("div", self, o)
    def __rtruediv__(self, o): return self.rec.binary("div", o, self)
    def __eq__(self, o): return self.rec.binary("eq", self, o)  # noqa: E704
    def __ne__(self, o): return self.rec.binary("ne", self, o)
    def __lt__(self, o): return self.rec.binary("lt", self, o)
    def __gt__(self, o): return self.rec.binary("gt", self, o)
    def __le__(self, o): return self.rec.binary("le", self, o)
    def __ge__(self, o): return self.rec.binary("ge", self, o)
    def __neg__(self): return self.rec.unary("neg", self)
    def __pos__(self): return self
    def __abs__(self): return self.rec.unary("abs", self)

    __hash__ = object.__hash__

    def __pow__(self, o):
        if isinstance(o, torch.Tensor) and o.dim() == 0:
            o = float(o)
        if not isinstance(o, (numbers.Real, np.number)):
            raise NotImplementedError(
                "pow with a traced exponent (the fused kernel takes x ** c "
                "with a constant c)")
        return self.rec.add("pow", self.i, -1, float(o))

    def __rpow__(self, o):
        raise NotImplementedError(
            "pow with a traced exponent (the fused kernel takes x ** c "
            "with a constant c)")

    def __bool__(self):
        raise NotImplementedError(
            "data-dependent Python control flow (the truth value of a "
            "traced slot); write it with comparisons, e.g. (a == 1.0) * b")

    def _no(self, *_):
        raise NotImplementedError(
            "converting a traced slot to a Python number")

    __float__ = __int__ = __index__ = _no

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise NotImplementedError(
            f"method {name!r} of a traced slot is outside the fused kernel's "
            f"op set {OPS[4:]}")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", repr(func))
        if kwargs:
            raise NotImplementedError(f"torch.{name} with keyword arguments")
        rec = next(a.rec for a in args if isinstance(a, _Node))
        if name in _TORCH_UNARY and len(args) == 1:
            return rec.unary(_TORCH_UNARY[name], args[0])
        if name in _TORCH_BINARY and len(args) == 2:
            op, swap = _TORCH_BINARY[name]
            x, y = (args[1], args[0]) if swap else args
            return rec.binary(op, x, y)
        if name in ("pow", "__pow__") and len(args) == 2:
            return _Node.__pow__(args[0], args[1])
        raise NotImplementedError(
            f"torch.{name} is outside the fused kernel's op set {OPS[4:]}")


class _ParamRows:
    """``params[k]`` of the planar layout: rows are read by static slices
    ``[i:i+1]``, each a leaf naming row ``offset + i`` of the bucket's
    flattened parameter table."""

    def __init__(self, rec: _Recorder, name: str, offset: int, n_rows: int):
        self.rec, self.name, self.offset, self.n_rows = rec, name, offset, n_rows

    def __getitem__(self, key):
        if isinstance(key, slice) and key.step in (None, 1):
            i = 0 if key.start is None else key.start
            stop = self.n_rows if key.stop is None else key.stop
            if stop - i == 1 and 0 <= i < self.n_rows:
                return self.rec.add("param", self.offset + i)
        raise NotImplementedError(
            f"params[{self.name!r}][{key!r}]: the fused kernel reads one "
            f"parameter row at a time (leaf[i:i+1])")

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise NotImplementedError(f"params[{self.name!r}].{name}")


def trace_planar(planar, pattern: Sequence[bool],
                 param_rows: Dict[str, int]) -> Tape:
    """Run ``planar(params, slots)`` once on proxies → the pruned tape.

    ``param_rows`` maps each parameter name to its row count in the
    planar layout; rows are numbered in sorted-name order, as
    :func:`param_table` lays them out.
    """
    rec = _Recorder()
    slots, ci, di = [], 0, 0
    for is_cont in pattern:
        if is_cont:
            slots.append(rec.add("cont", ci))
            ci += 1
        else:
            slots.append(rec.add("disc", di))
            di += 1
    params, off = {}, 0
    for k in sorted(param_rows):
        params[k] = _ParamRows(rec, k, off, param_rows[k])
        off += param_rows[k]
    out = rec.index(planar(params, slots))
    # keep the nodes the output reaches, in order (the output comes last)
    keep = np.zeros(len(rec.nodes), bool)
    keep[out] = True
    for i in range(out, -1, -1):
        if keep[i]:
            op, a, b, _ = rec.nodes[i]
            if op not in _LEAVES:
                keep[a] = True
                if b >= 0:
                    keep[b] = True
    new = np.cumsum(keep) - 1
    ops, aa, bb, cc, grad = [], [], [], [], []
    for i in np.flatnonzero(keep[: out + 1]):
        op, a, b, c = rec.nodes[i]
        if op in _LEAVES:
            g = op == "cont"
        else:
            a, b = int(new[a]), (int(new[b]) if b >= 0 else -1)
            g = op not in _CMP and (grad[a] or (b >= 0 and grad[b]))
        ops.append(op)
        aa.append(a)
        bb.append(b)
        cc.append(float(c))
        grad.append(bool(g))
    if len(ops) > MAX_NODES:
        raise NotImplementedError(
            f"a log-potential of {len(ops)} tape nodes (the fused kernel "
            f"holds at most {MAX_NODES})")
    return Tape(tuple(ops), tuple(aa), tuple(bb), tuple(cc), tuple(grad))


def param_table(params: Dict[str, np.ndarray], n_f: int) -> np.ndarray:
    """Stack a bucket's parameters in the planar layout: ``[n_f, P]`` f32,
    name-sorted, each leaf's per-factor components flattened row-major."""
    cols = [np.asarray(params[k], np.float32).reshape(n_f, -1)
            for k in sorted(params)]
    return (np.concatenate(cols, axis=1) if cols
            else np.zeros((n_f, 0), np.float32))


def tape_forward(tape: Tape, cont, disc, prm) -> list:
    """Node values of one bucket's tape: ``cont``/``disc`` are lists of
    ``[C, R]`` slot tensors, ``prm`` the ``[R, P]`` parameter table."""
    v: list = []
    for op, a, b, c in zip(tape.ops, tape.a, tape.b, tape.c):
        if op == "const":
            out = torch.full((), c, dtype=torch.float32, device=prm.device)
        elif op == "cont":
            out = cont[a]
        elif op == "disc":
            out = disc[a]
        elif op == "param":
            out = prm[:, a]
        elif op == "add":
            out = v[a] + v[b]
        elif op == "sub":
            out = v[a] - v[b]
        elif op == "mul":
            out = v[a] * v[b]
        elif op == "div":
            out = v[a] / v[b]
        elif op == "neg":
            out = -v[a]
        elif op == "pow":
            out = v[a] ** c
        elif op == "exp":
            out = torch.exp(v[a])
        elif op == "log":
            out = torch.log(v[a])
        elif op == "abs":
            out = torch.abs(v[a])
        elif op == "min":
            out = torch.minimum(v[a], v[b])
        elif op == "max":
            out = torch.maximum(v[a], v[b])
        else:  # comparisons
            cmp = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
                   "gt": torch.gt, "le": torch.le, "ge": torch.ge}[op]
            out = cmp(v[a], v[b]).to(torch.float32)
        v.append(out)
    return v


def tape_reverse(tape: Tape, v: list, seed) -> Dict[int, torch.Tensor]:
    """Reverse sweep from ``d out = seed`` (``[C, R]``) → adjoint of each
    continuous slot that the output reaches (``{slot: [C, R]}``). The
    derivative rules are autograd's: ``abs'(0) = 0`` and ties of
    ``min``/``max`` split the adjoint evenly."""
    g: list = [None] * len(tape)
    g[-1] = seed
    slots: Dict[int, torch.Tensor] = {}

    def acc(i, d):
        if tape.grad[i]:
            g[i] = d if g[i] is None else g[i] + d

    for i in range(len(tape) - 1, -1, -1):
        if g[i] is None or not tape.grad[i]:
            continue
        op, a, b, c, gi = tape.ops[i], tape.a[i], tape.b[i], tape.c[i], g[i]
        if op == "cont":
            slots[a] = gi if a not in slots else slots[a] + gi
        elif op == "add":
            acc(a, gi)
            acc(b, gi)
        elif op == "sub":
            acc(a, gi)
            acc(b, -gi)
        elif op == "mul":
            acc(a, gi * v[b])
            acc(b, gi * v[a])
        elif op == "div":
            acc(a, gi / v[b])
            acc(b, -gi * v[a] / (v[b] * v[b]))
        elif op == "neg":
            acc(a, -gi)
        elif op == "pow":
            acc(a, gi * (c * v[a] ** (c - 1.0)) if c != 0.0 else 0.0 * gi)
        elif op == "exp":
            acc(a, gi * v[i])
        elif op == "log":
            acc(a, gi / v[a])
        elif op == "abs":
            acc(a, gi * torch.sign(v[a]))
        elif op in ("min", "max"):
            first = v[a] < v[b] if op == "min" else v[a] > v[b]
            tie = v[a] == v[b]
            wa = torch.where(tie, 0.5, first.to(torch.float32))
            acc(a, gi * wa)
            acc(b, gi * (1.0 - wa))
    return slots
