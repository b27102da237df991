"""The port's dataplane contracts: what the hand-maintained conventions
between the wrappers, their oracles, the host mirrors and the C bindings
must keep, checked mechanically.

The counterpart of ``repro.analysis.contracts``, for what the port has in
place of Pallas and XLA.  Its rules (``RULES``):

* every public entry of ``kernels/ops.py``, and ``kernels.flash_attention
  .flash_attention``, is registered with ``@dataplane_contract``: its
  oracle in ``core.batched`` (signature parity, as the reference checks
  it), the plain version its CPU route calls, and the reference's oracle by
  its dotted name (the port imports nothing of the reference);
* the host watermark, round and reclamation mirrors of ``core/api.py`` move
  only in ``__init__`` or in a ``@mirror_guard`` method;
* a registered entry updates its state in place and returns that state
  (``inplace_violations``, a run-time check that tests and ``chip_smoke.py``
  call: the port's counterpart of the reference's donation audit);
* every ``ctypes`` binding declares the parameters of the ``extern "C"``
  entry of ``csrc/*.cu`` it calls, in count and kind, and every entry that
  takes arguments is bound: the port's counterpart of the reference's
  pallas_call arity audit, since a launch goes through a hand-written
  ``argtypes`` list.

The reference's rules that exist only for Pallas or XLA are named in
``NOT_APPLICABLE`` with the reason.  Run it as

    python tools/check_contracts_torch.py          # exit 0 when clean
    python -m repro_torch.analysis.contracts       # the same

Violations print as ``file:line: RULE-ID: message``; the process exits
non-zero on any.  Importing this module imports no torch.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import importlib
import inspect
import os
import re
import sys
import textwrap
from collections.abc import Callable, Sequence
from typing import Any

RULES: dict[str, str] = {
    "ORACLE-PARITY": (
        "a registered entry and its oracle must match in parameter names, "
        "order and defaults, modulo declared extras; an entry with no "
        "oracle gives a reason; its plain version is the function its CPU "
        "route calls; its reference oracle is a dotted name in `repro`"
    ),
    "ORACLE-MISSING": (
        "every public entry in kernels/ops.py, and kernels.flash_attention"
        ".flash_attention, must be registered with @dataplane_contract"
    ),
    "MIRROR-GUARD": (
        "host watermark/round/reclamation mirrors may only be mutated in "
        "__init__ or @mirror_guard-annotated methods of core/api.py"
    ),
    "STATE-INPLACE": (
        "a registered entry must update its state_args in place (every "
        "tensor keeps its data_ptr) and return that state, not a copy"
    ),
    "BIND-ARITY": (
        "every ctypes binding's argtypes must match its extern \"C\" entry "
        "in csrc/*.cu in count and kind; every entry with arguments must be "
        "bound, every binding must name an existing entry, and argtypes are "
        "set only inside a registered binding function"
    ),
}

# The reference's rules (and its Pallas-only surface) with no counterpart
# here, each with the reason.
NOT_APPLICABLE: dict[str, str] = {
    "ALIAS-BIJECTION": "no input_output_aliases: a CUDA kernel writes state through raw pointers",
    "ALIAS-OFFSET": "no scalar-prefetch window to offset an alias by: scalars are C arguments",
    "ALIAS-ARITY": "no pallas_call: a call site's arity drift lives in its ctypes binding "
    "(BIND-ARITY)",
    "PREFETCH-ORDER": "no scalar-prefetch vector: each C entry's parameters are held (BIND-ARITY)",
    "DONATE-STATE": "no jax.jit donation: state is updated in place, checked at run time "
    "(STATE-INPLACE)",
    "DONATE-MISSING": "no jax.jit donation: state is updated in place, checked at run time "
    "(STATE-INPLACE)",
    "DONATE-USE": "no donated buffer to read after a call: the state tensors stay valid "
    "(STATE-INPLACE)",
    "KERNEL-PURITY": "no traced Python kernel bodies: the kernels are CUDA C++ in csrc/",
    "KERNEL-HOST": "no traced Python kernel bodies: the kernels are CUDA C++ in csrc/",
    "pallas_sites": "no pallas_call sites; the C entries bound right are counted instead "
    "(summary)",
}


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    file: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: {self.rule}: {self.message}"


# ---------------------------------------------------------------------------
# Contract registry: @dataplane_contract links wrappers to their oracles
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ContractEntry:
    """One entry's declared contract.

    ``oracle`` is its plain oracle in the port (``core.batched`` or
    ``kernels.ref``), held to the entry's signature; ``plain`` the function
    its CPU route calls; ``jax_oracle`` the dotted name of the reference's
    oracle, which the port's tests resolve.  ``state_args`` are the
    parameters whose tensors the entry updates in place.
    ``extra``/``oracle_extra`` name parameters that exist on one side of
    the entry/oracle pair only; ``strict_order=False`` compares name sets
    and defaults alone.  An entry with no oracle gives a ``reason``.
    """

    name: str
    fn: Callable[..., Any]
    oracle: Callable[..., Any] | None
    plain: Callable[..., Any] | None
    jax_oracle: str | None
    state_args: tuple[str, ...]
    extra: tuple[str, ...]
    oracle_extra: tuple[str, ...]
    strict_order: bool
    reason: str | None


CONTRACT_REGISTRY: dict[str, ContractEntry] = {}


def dataplane_contract(
    oracle: Callable[..., Any] | None = None,
    *,
    plain: Callable[..., Any] | None,
    jax_oracle: str | None,
    state_args: Sequence[str] = (),
    extra: Sequence[str] = (),
    oracle_extra: Sequence[str] = (),
    strict_order: bool = True,
    reason: str | None = None,
) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
    """Register an entry against its oracle; returns the function unchanged."""

    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        CONTRACT_REGISTRY[fn.__name__] = ContractEntry(
            name=fn.__name__,
            fn=fn,
            oracle=oracle,
            plain=plain,
            jax_oracle=jax_oracle,
            state_args=tuple(state_args),
            extra=tuple(extra),
            oracle_extra=tuple(oracle_extra),
            strict_order=strict_order,
            reason=reason,
        )
        return fn

    return deco


def mirror_guard(fn: Callable[..., Any]) -> Callable[..., Any]:
    """Marks a ``core/api.py`` method as a place where the host watermark,
    round and reclamation mirrors may move (dispatches that advance them
    with a device round, guards and restores that re-seed them)."""
    fn.__mirror_guard__ = True
    return fn


# Host mirrors paired with device watermark/round/reclamation state.
MIRROR_ATTRS = frozenset(
    {
        "next_inst_host",
        "_next_inst_host",
        "crnd_host",
        "reclaimed_host",
        "_reclaim_marks",
    }
)

# Modules whose entries are registered: None for every public function.
REGISTERED_SURFACE: dict[str, tuple[str, ...] | None] = {
    "kernels/ops.py": None,
    "kernels/flash_attention.py": ("flash_attention",),
}

# C parameter types -> ctypes kinds; any pointer is a c_void_p.
_C_KINDS = {"int": "c_int", "float": "c_float"}


# ---------------------------------------------------------------------------
# ORACLE-PARITY and ORACLE-MISSING
# ---------------------------------------------------------------------------
def _dotted(node: ast.expr) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _positional_params(fn: Callable[..., Any]) -> list[inspect.Parameter]:
    return [
        p
        for p in inspect.signature(fn).parameters.values()
        if p.kind not in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
    ]


def _srcinfo(fn: Callable[..., Any], root: str | None) -> tuple[str, int]:
    try:
        f = inspect.getsourcefile(fn) or "<unknown>"
        line = inspect.getsourcelines(fn)[1]
    except (OSError, TypeError):
        return "<unknown>", 0
    if root:
        f = os.path.relpath(f, root)
    return f, line


def _names_used(fn: Callable[..., Any]) -> set[str] | None:
    """Every name and attribute the function's body mentions, or None when
    its source cannot be read."""
    try:
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    except (OSError, TypeError, SyntaxError):
        return None
    used: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            used.add(node.attr)
    return used


_JAX_NAME = re.compile(r"repro(\.\w+)+")


def signature_violations(entry: ContractEntry, root: str | None = None) -> list[Violation]:
    """Hold a registered entry against its oracle (names, order, defaults),
    modulo its declared extras, and check its plain version and reference
    name."""
    file, line = _srcinfo(entry.fn, root)
    out: list[Violation] = []

    def bad(msg: str) -> None:
        out.append(Violation("ORACLE-PARITY", file, line, f"{entry.name}: {msg}"))

    if entry.plain is None:
        bad("registered without its plain version")
    else:
        used = _names_used(entry.fn)
        if used is not None and entry.plain.__name__ not in used:
            bad(f"the plain version `{entry.plain.__name__}` is not called by the entry")
    if entry.jax_oracle is None:
        if not entry.reason:
            bad("registered without a reference oracle and without a reason")
    elif not _JAX_NAME.fullmatch(entry.jax_oracle):
        bad(f"reference oracle `{entry.jax_oracle}` is not a dotted name in the `repro` package")

    wparams = _positional_params(entry.fn)
    wnames = {p.name for p in wparams}
    for x in entry.extra:
        if x not in wnames:
            bad(f"declared extra param `{x}` does not exist on the entry (stale registration)")
    if entry.oracle is None:
        if not entry.reason:
            bad("registered without an oracle and without a reason")
        return out
    oparams = _positional_params(entry.oracle)
    onames = {p.name for p in oparams}
    for x in entry.oracle_extra:
        if x not in onames:
            bad(f"declared oracle_extra param `{x}` does not exist on the oracle "
                "(stale registration)")
    ws = [p for p in wparams if p.name not in entry.extra]
    os_ = [p for p in oparams if p.name not in entry.oracle_extra]
    oracle_name = getattr(entry.oracle, "__name__", "<oracle>")
    if entry.strict_order:
        if [p.name for p in ws] != [p.name for p in os_]:
            bad(f"params {[p.name for p in ws]} != oracle {oracle_name} params "
                f"{[p.name for p in os_]} (modulo declared extras)")  # fmt: skip
            return out
        pairs = list(zip(ws, os_, strict=True))
    else:
        if {p.name for p in ws} != {p.name for p in os_}:
            bad(f"shared param name sets differ from oracle {oracle_name}: "
                f"{sorted(p.name for p in ws)} vs {sorted(p.name for p in os_)}")  # fmt: skip
            return out
        by_name = {p.name: p for p in os_}
        pairs = [(p, by_name[p.name]) for p in ws]
    for wp, op in pairs:
        wd, od = wp.default, op.default
        if (wd is inspect.Parameter.empty) != (od is inspect.Parameter.empty):
            bad(f"param `{wp.name}` required on one side but defaulted on the other")
        elif wd is not inspect.Parameter.empty and wd != od:
            bad(f"param `{wp.name}` default {wd!r} != oracle default {od!r}")
    return out


def _load_registry() -> None:
    for rel in REGISTERED_SURFACE:
        importlib.import_module("repro_torch." + rel[: -len(".py")].replace("/", "."))


def check_registry(root: str) -> list[Violation]:
    """Parity for every registered entry, and every entry of the registered
    surface registered."""
    _load_registry()
    out: list[Violation] = []
    for tail, names in REGISTERED_SURFACE.items():
        rel = os.path.join("src", "repro_torch", tail)
        tree = ast.parse(_read(root, rel), filename=rel)
        for node in tree.body:
            if not isinstance(node, ast.FunctionDef):
                continue
            wanted = not node.name.startswith("_") if names is None else node.name in names
            if wanted and node.name not in CONTRACT_REGISTRY:
                out.append(Violation("ORACLE-MISSING", rel, node.lineno,
                                     f"public entry `{node.name}` has no @dataplane_contract "
                                     f"registration"))  # fmt: skip
    for entry in CONTRACT_REGISTRY.values():
        out.extend(signature_violations(entry, root))
    return out


# ---------------------------------------------------------------------------
# MIRROR-GUARD
# ---------------------------------------------------------------------------
def _terminal_attr(node: ast.expr) -> tuple[str, int] | None:
    """Attribute name and line of a store through ``x.attr`` or
    ``x.attr[...]`` (any base, so ``self.hw._x`` and ``self.x[gid]``)."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute):
        return node.attr, node.lineno
    return None


def _guarded(fdef: ast.FunctionDef) -> bool:
    return any((_dotted(d) or "").split(".")[-1] == "mirror_guard" for d in fdef.decorator_list)


def guarded_methods(src: str) -> list[tuple[str, str]]:
    """The ``(class, method)`` pairs marked ``@mirror_guard`` in ``src``."""
    tree = ast.parse(src)
    return [
        (cdef.name, fdef.name)
        for cdef in ast.walk(tree)
        if isinstance(cdef, ast.ClassDef)
        for fdef in cdef.body
        if isinstance(fdef, ast.FunctionDef) and _guarded(fdef)
    ]


def check_mirror_source(src: str, filename: str) -> list[Violation]:
    tree = ast.parse(src, filename=filename)
    out: list[Violation] = []
    for cdef in (n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)):
        for fdef in cdef.body:
            if not isinstance(fdef, ast.FunctionDef) or fdef.name == "__init__" or _guarded(fdef):
                continue
            for node in ast.walk(fdef):
                targets: list[ast.expr] = []
                if isinstance(node, ast.Assign):
                    targets = list(node.targets)
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                for t in targets:
                    for leaf in t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]:
                        hit = _terminal_attr(leaf)
                        if hit is not None and hit[0] in MIRROR_ATTRS:
                            out.append(Violation("MIRROR-GUARD", filename, hit[1],
                                                 f"{cdef.name}.{fdef.name} mutates host mirror "
                                                 f"`{hit[0]}` outside a @mirror_guard-annotated "
                                                 f"method"))  # fmt: skip
    return out


# ---------------------------------------------------------------------------
# STATE-INPLACE (run time)
# ---------------------------------------------------------------------------
def _fields(state: Any) -> dict[str, Any]:
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def _holds(state: Any, ptrs: dict[str, tuple[int, tuple]]) -> bool:
    return all(
        t.data_ptr() == ptr and tuple(t.shape) == shape
        for t, (ptr, shape) in zip(_fields(state).values(), ptrs.values(), strict=True)
    )


def inplace_violations(entry: ContractEntry, *args: Any, **kw: Any) -> list[Violation]:
    """Run the entry on ``args`` (the route its tensors' device picks) and
    check that every ``state_args`` tensor kept its storage and that the
    entry returned that same state."""
    file, line = _srcinfo(entry.fn, None)
    bound = inspect.signature(entry.fn).bind(*args, **kw)
    before = {}
    for name in entry.state_args:
        state = bound.arguments[name]
        ptrs = {f: (t.data_ptr(), tuple(t.shape)) for f, t in _fields(state).items()}
        before[name] = (state, ptrs)
    result = entry.fn(*args, **kw)
    returned = result if isinstance(result, tuple) else (result,)
    out: list[Violation] = []
    for name, (state, ptrs) in before.items():
        moved = [
            f for f, t in _fields(state).items() if (t.data_ptr(), tuple(t.shape)) != ptrs[f]
        ]
        if moved:
            out.append(Violation("STATE-INPLACE", file, line,
                                 f"{entry.name}: `{name}` fields {moved} no longer hold the "
                                 f"tensors passed in"))  # fmt: skip
        if not any(type(r) is type(state) and _holds(r, ptrs) for r in returned):
            out.append(Violation("STATE-INPLACE", file, line,
                                 f"{entry.name}: returns no {type(state).__name__} holding the "
                                 f"`{name}` tensors passed in (a copy?)"))  # fmt: skip
    return out


def state_cases(device, *, a=3, n=64, v=4, b=8, g=4, k=2, seed=0) -> dict[str, tuple]:
    """``(args, kwargs)`` for every entry that updates state in place, on
    ``device``: windows that wrap past the ring's end, a dead acceptor, a
    quorum of ``a // 2 + 1``, ``g`` groups for the grouped entries (a
    cohort of the first and last, half of them on a shard's slab) and ``k``
    rounds for a wave.  ``b`` must divide ``n`` and ``k * b <= n``."""
    import numpy as np
    import torch

    from repro_torch.core.batched import LearnerState
    from repro_torch.core.types import MSG_P2A, AcceptorState, CoordinatorState, MsgBatch

    rng = np.random.default_rng(seed)

    def ints(*shape, lo=-(2**31), hi=2**31 - 1):
        x = rng.integers(lo, hi, shape, dtype=np.int32, endpoint=True)
        return torch.from_numpy(x).to(device)

    def ring(*lead):
        return AcceptorState(ints(*lead, n, lo=0, hi=8), ints(*lead, n, lo=-1, hi=8),
                             ints(*lead, n, v))  # fmt: skip

    def learner(*lead):
        return LearnerState(ints(*lead, n, lo=0, hi=1), ints(*lead, n, lo=-1, hi=n),
                            ints(*lead, n, v))  # fmt: skip

    i32 = dict(dtype=torch.int32, device=device)
    quorum, base = a // 2 + 1, n - b // 2
    lanes = torch.arange(b, **i32)
    msgs = MsgBatch(
        msgtype=torch.full((b,), MSG_P2A, **i32), inst=(base + lanes) % n,
        rnd=torch.full((b,), 8, **i32), vrnd=torch.full((b,), -1, **i32),
        swid=torch.zeros((b,), **i32), value=ints(b, v),
    )  # fmt: skip
    alive = torch.ones((g, a), dtype=torch.bool, device=device)
    alive[0, 0] = False
    ni, crnd = torch.full((g,), base, **i32), ints(g, lo=1, hi=8)
    cohort = [0, g - 1]
    wen = np.ones((k, g), np.int32)
    wni = (base + b * np.arange(k, dtype=np.int32))[:, None].repeat(g, axis=1)
    seg = torch.tensor(cohort[::-1], **i32)
    cstate = CoordinatorState(torch.tensor(base, **i32), torch.tensor(5, **i32))
    return {
        "acceptor_phase2": ((ring(), msgs, 1), {}),
        "acceptor_phase2_all": ((ring(a), msgs, alive[0]), {}),
        "fused_round": ((cstate, ring(a), learner(), ints(b, v),
                         torch.ones((b,), dtype=torch.bool, device=device), alive[0], quorum), {}),
        "multigroup_fused_round": ((CoordinatorState(ni.clone(), crnd.clone()), ring(g, a),
                                    learner(g), ints(g, b, v),
                                    torch.ones((g, b), dtype=torch.bool, device=device), alive,
                                    quorum), {}),
        "cohort_fused_round": ((ring(g, a), learner(g), cohort, ni, crnd, alive, quorum,
                                ints(len(cohort), b, v), torch.ones((g,), **i32)), {}),
        "shard_slab_round": ((g // 2, ni, crnd, alive, quorum, ring(g - g // 2, a),
                              learner(g - g // 2), ints(g - g // 2, b, v)), {}),
        "packed_shard_round": ((ring(g, a), learner(g), seg, ni[:2], crnd[:2],
                                alive[:2].to(torch.int32), quorum, ints(2, b, v),
                                torch.ones((2,), **i32)), {"block_b": b}),
        "persistent_cohort_rounds": ((ring(g, a), learner(g), cohort, wni, wen, crnd, alive,
                                      quorum, ints(k, len(cohort), b, v)), {"block_b": b}),
    }  # fmt: skip


def check_inplace(device, **shape: int) -> tuple[list[Violation], int]:
    """STATE-INPLACE through every registered entry with ``state_args``, on
    ``state_cases(device, **shape)``.  Returns the violations and the number
    of entries run."""
    _load_registry()
    cases = state_cases(device, **shape)
    out: list[Violation] = []
    ran = 0
    for entry in CONTRACT_REGISTRY.values():
        if not entry.state_args:
            continue
        if entry.name not in cases:
            file, line = _srcinfo(entry.fn, None)
            out.append(Violation("STATE-INPLACE", file, line,
                                 f"{entry.name}: no case in state_cases to run it on"))  # fmt: skip
            continue
        args, kw = cases[entry.name]
        out.extend(inplace_violations(entry, *args, **kw))
        ran += 1
    return out, ran


# ---------------------------------------------------------------------------
# BIND-ARITY
# ---------------------------------------------------------------------------
_EXTERN = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(\w+)\s*\(([^()]*)\)\s*\{')
_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


def c_entries(src: str) -> dict[str, tuple[list[str] | str, int]]:
    """Each ``extern "C"`` definition in a CUDA source: its name -> (its
    parameters' ctypes kinds, or the text of the first parameter of a type
    it cannot map; its line)."""
    src = _COMMENT.sub(lambda m: re.sub(r"[^\n]", " ", m.group()), src)
    out: dict[str, tuple[list[str] | str, int]] = {}
    for m in _EXTERN.finditer(src):
        params = [p.strip() for p in m.group(2).split(",")]
        if params in ([""], ["void"]):
            params = []
        kinds: list[str] | str = []
        for p in params:
            if "*" in p:
                kinds.append("c_void_p")
                continue
            kind = _C_KINDS.get(" ".join(p.split()[:-1]).replace("const ", ""))
            if kind is None:
                kinds = p
                break
            kinds.append(kind)
        out[m.group(1)] = (kinds, src.count("\n", 0, m.start()) + 1)
    return out


@dataclasses.dataclass(frozen=True)
class Binding:
    """How a kernel module types one C entry of ``csrc/<library>.cu``:
    ``bind(lib, entry)`` sets the entry's ``argtypes`` and ``restype`` on
    the loaded library ``lib`` and returns the function."""

    library: str
    entry: str
    bind: Callable[[Any, str], Any]

    def load(self, library: Callable[[str], Any]) -> Any:
        """The typed entry of ``library(self.library)``."""
        return self.bind(library(self.library), self.entry)


class _Recorded:
    """A C function of ``RecordingLibrary``: it takes ``argtypes`` and
    ``restype``, and answers a call only where its library was told what."""

    def __init__(self, name: str, answer: Any):
        self.__name__ = name
        self._answer = answer
        self.argtypes: Sequence[Any] | None = None
        self.restype: Any = None

    def __call__(self, *args: Any) -> Any:
        if self._answer is None:
            raise RuntimeError(f"{self.__name__}: a recording library launches nothing")
        return self._answer


class RecordingLibrary:
    """A stand-in for a loaded ``csrc/<name>.cu`` library on a machine with
    no card: the bindings type its functions as they would the real ones.
    ``answers`` gives what an argument-free query returns."""

    def __init__(self, name: str, answers: dict[str, Any] | None = None):
        self._name = name
        self._answers = answers or {}
        self._functions: dict[str, _Recorded] = {}

    def __getattr__(self, entry: str) -> _Recorded:
        if entry.startswith("_"):
            raise AttributeError(entry)
        fn = self._functions.get(entry)
        if fn is None:
            fn = self._functions[entry] = _Recorded(entry, self._answers.get(entry))
        return fn


def recording_library(name: str) -> RecordingLibrary:
    """The recording stand-in for ``_build.library(name)``: it answers
    ``tree_digest_leaf_bytes`` with the size of the port's leaf record, as
    the built library does when the two agree."""
    import ctypes

    leaf = importlib.import_module("repro_torch.kernels.digest")._Leaf
    return RecordingLibrary(name, {"tree_digest_leaf_bytes": ctypes.sizeof(leaf)})


# Every module that binds a C entry, each with a ``BINDINGS`` tuple.
BINDING_MODULES = (
    "repro_torch.kernels.acceptor",
    "repro_torch.kernels.coordinator",
    "repro_torch.kernels.digest",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.learner",
    "repro_torch.kernels.wirepath",
)

# Files where an ``argtypes`` assignment may stand, and then only inside a
# registered binding function.
BINDING_SCAN = ("src/repro_torch/kernels", "chip_smoke.py")


def bindings() -> list[Binding]:
    return [b for mod in BINDING_MODULES for b in importlib.import_module(mod).BINDINGS]


class _ArgtypesSites(ast.NodeVisitor):
    """``(line, enclosing function)`` of every ``.argtypes = ...``."""

    def __init__(self) -> None:
        self.scope = ["<module>"]
        self.sites: list[tuple[int, str]] = []

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    def visit_Assign(self, node: ast.Assign) -> None:
        if any(isinstance(t, ast.Attribute) and t.attr == "argtypes" for t in node.targets):
            self.sites.append((node.lineno, self.scope[-1]))
        self.generic_visit(node)


def _argtypes_sites(root: str) -> list[tuple[str, int, str]]:
    """``(file, line, enclosing function)`` of every ``.argtypes = ...``
    under ``BINDING_SCAN``."""
    files: list[str] = []
    for rel in BINDING_SCAN:
        path = os.path.join(root, rel)
        if os.path.isdir(path):
            files += sorted(os.path.join(rel, n) for n in os.listdir(path) if n.endswith(".py"))
        elif os.path.exists(path):
            files.append(rel)
    sites = []
    for rel in files:
        visitor = _ArgtypesSites()
        visitor.visit(ast.parse(_read(root, rel), filename=rel))
        sites += [(rel, line, fname) for line, fname in visitor.sites]
    return sites


def check_bindings(
    root: str,
    library: Callable[[str], Any] | None = None,
    binds: Sequence[Binding] | None = None,
) -> tuple[list[Violation], int]:
    """BIND-ARITY over ``csrc/*.cu`` and the bindings, each bound on
    ``library(name)`` (default: ``recording_library``; on the card,
    ``_build.library``).  Returns the violations and the number of C entries
    with arguments that are bound right."""
    library = library or recording_library
    binds = bindings() if binds is None else binds
    out: list[Violation] = []
    csrc = os.path.join("src", "repro_torch", "csrc")
    entries: dict[tuple[str, str], tuple[list[str] | str, str, int]] = {}
    for name in sorted(os.listdir(os.path.join(root, csrc))):
        if name.endswith(".cu"):
            rel = os.path.join(csrc, name)
            for entry, (kinds, line) in c_entries(_read(root, rel)).items():
                entries[(name[: -len(".cu")], entry)] = (kinds, rel, line)
    bound: dict[tuple[str, str], list[str]] = {}
    for b in binds:
        file, line = _srcinfo(b.bind, root)
        key = (b.library, b.entry)
        if key not in entries:
            out.append(Violation("BIND-ARITY", file, line,
                                 f"binding of `{b.entry}` names no extern \"C\" entry of "
                                 f"csrc/{b.library}.cu"))  # fmt: skip
            continue
        try:
            fn = b.load(library)
        except AttributeError as e:
            out.append(Violation("BIND-ARITY", file, line,
                                 f"binding of `{b.entry}` finds no such function in the built "
                                 f"library {b.library}: {e}"))  # fmt: skip
            continue
        bound[key] = [t.__name__ for t in fn.argtypes or ()]
    ok = 0
    for key, (kinds, rel, line) in sorted(entries.items()):
        lib, entry = key
        if isinstance(kinds, str):
            out.append(Violation("BIND-ARITY", rel, line,
                                 f"`{entry}`: parameter `{kinds}` has no ctypes kind here "
                                 f"(int, float or a pointer)"))  # fmt: skip
            continue
        if not kinds:
            continue  # called with no arguments, no argtypes to hold
        got = bound.get(key)
        if got is None:
            out.append(Violation("BIND-ARITY", rel, line,
                                 f"`{entry}` takes {len(kinds)} arguments and no binding types "
                                 f"it"))  # fmt: skip
        elif got != kinds:
            diff = [i for i, (g, k) in enumerate(zip(got, kinds)) if g != k]
            out.append(Violation("BIND-ARITY", rel, line,
                                 f"`{entry}`: C takes {len(kinds)} arguments, the binding "
                                 f"declares {len(got)}; kinds differ at {diff}: C {kinds} vs "
                                 f"argtypes {got}"))  # fmt: skip
        else:
            ok += 1
    allowed = {(_srcinfo(b.bind, root)[0], b.bind.__name__) for b in binds}
    for rel, line, fname in _argtypes_sites(root):
        if (rel, fname) not in allowed:
            out.append(Violation("BIND-ARITY", rel, line,
                                 f"`argtypes` set in `{fname}`, which no module's BINDINGS "
                                 f"names: the check cannot see it"))  # fmt: skip
    return out, ok


# ---------------------------------------------------------------------------
# Repo driver
# ---------------------------------------------------------------------------
def _default_root() -> str:
    # src/repro_torch/analysis/contracts.py -> repo root
    here = os.path.abspath(os.path.dirname(__file__))
    return os.path.abspath(os.path.join(here, "..", "..", ".."))


def _read(root: str, rel: str) -> str:
    with open(os.path.join(root, rel), encoding="utf-8") as f:
        return f.read()


def _ensure_importable(root: str) -> None:
    src = os.path.join(root, "src")
    if src not in sys.path:
        sys.path.insert(0, src)


API = os.path.join("src", "repro_torch", "core", "api.py")


def check_repo(
    root: str | None = None, library: Callable[[str], Any] | None = None
) -> list[Violation]:
    """Every static rule over the repository: ORACLE-*, MIRROR-GUARD and
    BIND-ARITY, the bindings made on ``library`` (see ``check_bindings``)."""
    root = root or _default_root()
    _ensure_importable(root)
    out = check_mirror_source(_read(root, API), API)
    out.extend(check_registry(root))
    out.extend(check_bindings(root, library)[0])
    return sorted(out, key=lambda v: (v.file, v.line, v.rule))


def summary(root: str | None = None, library: Callable[[str], Any] | None = None) -> dict:
    """The counts a clean run reports: registered entries, guarded
    methods, C entries bound right."""
    root = root or _default_root()
    _ensure_importable(root)
    _load_registry()
    return {
        "registered": len(CONTRACT_REGISTRY),
        "guarded": len(guarded_methods(_read(root, API))),
        "bound": check_bindings(root, library)[1],
    }


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.contracts",
        description="The port's dataplane contract checker.",
    )
    ap.add_argument("--root", default=None, help="repository root (default: inferred)")
    ns = ap.parse_args(argv)
    violations = check_repo(ns.root)
    for v in violations:
        print(v, file=sys.stderr)
    if violations:
        print(f"contracts: {len(violations)} violation(s)", file=sys.stderr)
        return 1
    counts = summary(ns.root)
    print(
        f"contracts OK: {counts['registered']} registered entries, {counts['guarded']} guarded "
        f"methods, {counts['bound']} bound C entries"
    )
    return 0


if __name__ == "__main__":
    # ``python -m`` runs this file as ``__main__``; delegate to the module
    # that the kernels register with, so its registry is the one read.
    from repro_torch.analysis.contracts import main as _main

    sys.exit(_main())
