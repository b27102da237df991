"""The port's contract checker (``repro_torch.analysis.contracts``): clean on
the live port, red on fixtures that each carry one break of one rule, and
in step with the reference's registry and mirror guards.

Each fixture seeds exactly one defect: a default, arity or name drift
against the oracle, an entry with no oracle and no reason, a public entry
with no registration, an unguarded mirror write, a binding one argument
short or of the wrong kind, and an entry that returns a copy of its state.
The test asserts the rule id the checker reports, not merely some failure.
"""

from __future__ import annotations

import ast
import ctypes
import importlib
import inspect
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import contracts as jcontracts  # noqa: E402
from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.analysis.contracts import (  # noqa: E402
    CONTRACT_REGISTRY,
    NOT_APPLICABLE,
    RULES,
    Binding,
    ContractEntry,
    RecordingLibrary,
    check_bindings,
    check_mirror_source,
    check_registry,
    check_repo,
    inplace_violations,
    signature_violations,
)
from repro_torch.core.types import AcceptorState  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _rules(violations):
    return {v.rule for v in violations}


# ---------------------------------------------------------------------------
# The live port is clean
# ---------------------------------------------------------------------------
def test_port_is_contract_clean():
    violations = check_repo()
    assert violations == [], "\n".join(str(v) for v in violations)


@pytest.mark.parametrize(
    "command",
    [["tools/check_contracts_torch.py"], ["-m", "repro_torch.analysis.contracts"]],
    ids=["tool", "module"],
)
def test_checker_exits_zero_in_a_subprocess(command, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cwd = ROOT if command[0] == "-m" else tmp_path
    if command[0] != "-m":
        command = [str(ROOT / command[0])]
    out = subprocess.run([sys.executable, *command], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=120)  # fmt: skip
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == (
        "contracts OK: 13 registered entries, 18 guarded methods, 12 bound C entries"
    )
    assert "jax" not in out.stderr


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_catalogue_has_descriptions(rule):
    assert RULES[rule]


def test_rules_and_not_applicable_cover_the_reference_exactly():
    """Every reference rule is carried over or declared not applicable with
    a reason; the port's own rules are the two that replace Pallas-only
    ones; a name in NOT_APPLICABLE that is no rule is reference API."""
    ref = set(jcontracts.RULES)
    na_rules = {k for k in NOT_APPLICABLE if k in ref}
    assert na_rules | (set(RULES) & ref) == ref
    assert not na_rules & set(RULES)
    assert set(RULES) - ref == {"STATE-INPLACE", "BIND-ARITY"}
    for name in set(NOT_APPLICABLE) - ref:
        assert callable(getattr(jcontracts, name)), name
    assert all(reason.strip() for reason in NOT_APPLICABLE.values())


# ---------------------------------------------------------------------------
# The registry against the port's surface and the reference's registry
# ---------------------------------------------------------------------------
def _public(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body if isinstance(n, ast.FunctionDef) and n.name[0] != "_"}


def test_registry_covers_ops_and_flash_attention():
    assert set(CONTRACT_REGISTRY) == _public(ROOT / "src/repro_torch/kernels/ops.py") | {
        "flash_attention"
    }
    for name, entry in CONTRACT_REGISTRY.items():
        assert entry.fn is (ops.__dict__.get(name) or entry.fn), name
        assert entry.plain is not None, name


def _params(fn) -> list[str]:
    return [
        p.name
        for p in inspect.signature(fn).parameters.values()
        if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
    ]


def _resolve(dotted: str):
    module, _, attr = dotted.rpartition(".")
    return getattr(importlib.import_module(module), attr)


def test_jax_oracles_resolve_and_signatures_equal_the_reference_entries():
    """Each reference oracle name resolves; each entry the reference also
    registers takes the reference entry's parameters, modulo the declared
    differences: a declared extra (`lanes_host`) or a parameter the reason
    names (`leaves` for `tree`)."""
    importlib.import_module("repro.kernels.ops")
    for name, entry in CONTRACT_REGISTRY.items():
        assert entry.jax_oracle is not None, name
        assert callable(_resolve(entry.jax_oracle)), entry.jax_oracle
        ref = jcontracts.CONTRACT_REGISTRY.get(name)
        if ref is None:
            continue
        mine, theirs = _params(entry.fn), _params(ref.fn)
        declared = set(entry.extra) | set(ref.extra)
        for p in set(mine) ^ set(theirs):
            assert p in declared or f"`{p}`" in (entry.reason or ""), (name, p)
        common = [p for p in mine if p in theirs]
        assert common == [p for p in theirs if p in mine], name
    port_only = set(CONTRACT_REGISTRY) - set(jcontracts.CONTRACT_REGISTRY)
    assert port_only == {"shard_slab_round", "flash_attention"}
    assert not set(jcontracts.CONTRACT_REGISTRY) - set(CONTRACT_REGISTRY)
    fa = CONTRACT_REGISTRY["flash_attention"]
    assert _params(fa.fn) == _params(_resolve(fa.jax_oracle))


def test_declared_differences_are_the_two_the_port_has():
    assert "lanes_host" in CONTRACT_REGISTRY["packed_shard_round"].extra
    tree = CONTRACT_REGISTRY["tree_digest"]
    assert _params(tree.fn) == ["leaves"] and "`leaves`" in tree.reason and "`tree`" in tree.reason


def test_mirror_guards_are_the_references():
    port = contracts.guarded_methods((ROOT / "src/repro_torch/core/api.py").read_text())
    ref = contracts.guarded_methods((ROOT / "src/repro/core/api.py").read_text())
    assert len(port) == 18 and sorted(port) == sorted(ref)


# ---------------------------------------------------------------------------
# ORACLE-PARITY fixtures
# ---------------------------------------------------------------------------
def _plain(state, msgs, enabled=None, limit=None):
    pass


def _entry(fn, oracle, **kw):
    kw.setdefault("plain", _plain)
    kw.setdefault("jax_oracle", "repro.core.batched.fused_round")
    kw.setdefault("state_args", ())
    kw.setdefault("extra", ())
    kw.setdefault("oracle_extra", ())
    kw.setdefault("strict_order", True)
    kw.setdefault("reason", None)
    return ContractEntry(name=fn.__name__, fn=fn, oracle=oracle, **kw)


def test_fixture_oracle_default_drift():
    def wrapper(state, msgs, enabled=None, limit=None):
        return _plain(state, msgs, enabled, limit)

    def oracle(state, msgs, enabled=None, limit=0):
        pass

    violations = signature_violations(_entry(wrapper, oracle))
    assert _rules(violations) == {"ORACLE-PARITY"}
    assert any("limit" in v.message for v in violations)


def test_fixture_oracle_arity_drift():
    def wrapper(state, msgs, enabled=None):
        return _plain(state, msgs, enabled)

    def oracle(state, msgs):
        pass

    assert _rules(signature_violations(_entry(wrapper, oracle))) == {"ORACLE-PARITY"}


def test_fixture_oracle_name_drift():
    def wrapper(state, messages):
        return _plain(state, messages)

    def oracle(state, msgs):
        pass

    assert _rules(signature_violations(_entry(wrapper, oracle))) == {"ORACLE-PARITY"}


def test_fixture_matching_signatures_pass():
    def wrapper(state, msgs, enabled=None, limit=None, group_block=1):
        return _plain(state, msgs, enabled, limit)

    violations = signature_violations(_entry(wrapper, _plain, extra=("group_block",)))
    assert violations == []


def test_fixture_no_oracle_and_no_reason():
    def wrapper(state):
        return _plain(state, None)

    assert _rules(signature_violations(_entry(wrapper, None))) == {"ORACLE-PARITY"}
    assert signature_violations(_entry(wrapper, None, reason="composed of `x`")) == []


def test_fixture_plain_version_not_called():
    def wrapper(state, msgs, enabled=None, limit=None):
        return None

    violations = signature_violations(_entry(wrapper, _plain))
    assert _rules(violations) == {"ORACLE-PARITY"}
    assert any("_plain" in v.message for v in violations)


@pytest.mark.parametrize("jax_oracle", [None, "jax.numpy.sum", "repro_torch.kernels.ref.digest"])
def test_fixture_reference_oracle_not_named(jax_oracle):
    def wrapper(state, msgs, enabled=None, limit=None):
        return _plain(state, msgs, enabled, limit)

    violations = signature_violations(_entry(wrapper, _plain, jax_oracle=jax_oracle))
    assert _rules(violations) == {"ORACLE-PARITY"}


# ---------------------------------------------------------------------------
# ORACLE-MISSING fixture
# ---------------------------------------------------------------------------
def test_fixture_public_entry_without_registration(tmp_path):
    kernels = tmp_path / "src" / "repro_torch" / "kernels"
    kernels.mkdir(parents=True)
    for name in ("ops.py", "flash_attention.py"):
        shutil.copy(ROOT / "src/repro_torch/kernels" / name, kernels / name)
    assert check_registry(str(tmp_path)) == []
    with open(kernels / "ops.py", "a") as f:
        f.write("\n\ndef new_entry(x):\n    return x\n")
    violations = check_registry(str(tmp_path))
    assert _rules(violations) == {"ORACLE-MISSING"}
    assert "new_entry" in violations[0].message


# ---------------------------------------------------------------------------
# MIRROR-GUARD fixtures
# ---------------------------------------------------------------------------
def test_fixture_unguarded_mirror_write():
    src = textwrap.dedent(
        """
        class Plane:
            def step(self):
                self.next_inst_host[0] = 5
        """
    )
    assert _rules(check_mirror_source(src, "fixture.py")) == {"MIRROR-GUARD"}


def test_fixture_guarded_mirror_write_is_clean():
    src = textwrap.dedent(
        """
        from repro_torch.analysis.contracts import mirror_guard


        class Plane:
            def __init__(self):
                self.next_inst_host = [0]

            @mirror_guard
            def step(self):
                self.next_inst_host[0] = 5
        """
    )
    assert check_mirror_source(src, "fixture.py") == []


# ---------------------------------------------------------------------------
# BIND-ARITY fixtures
# ---------------------------------------------------------------------------
_CU = """
// a kernel and its entries
extern "C" int scale(const void* x, int n, float s, /* the stream */ void* stream)
{
    return 0;
}

extern "C" int count() { return 1; }
"""

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind_right(lib, entry):
    fn = getattr(lib, entry)
    fn.argtypes = [P, I, F, P]
    return fn


def _bind_short(lib, entry):
    fn = getattr(lib, entry)
    fn.argtypes = [P, I, F]
    return fn


def _bind_kind(lib, entry):
    fn = getattr(lib, entry)
    fn.argtypes = [P, I, I, P]
    return fn


def _fixture_root(tmp_path, extra_py: str = ""):
    (tmp_path / "src/repro_torch/csrc").mkdir(parents=True)
    (tmp_path / "src/repro_torch/csrc/fixture.cu").write_text(_CU)
    if extra_py:
        (tmp_path / "src/repro_torch/kernels").mkdir(parents=True)
        (tmp_path / "src/repro_torch/kernels/stray.py").write_text(extra_py)
    return str(tmp_path)


def test_c_entries_parse_kinds():
    assert contracts.c_entries(_CU) == {
        "scale": (["c_void_p", "c_int", "c_float", "c_void_p"], 3),
        "count": ([], 8),
    }


def test_fixture_binding_matching_its_entry_is_clean(tmp_path):
    root = _fixture_root(tmp_path)
    binds = [Binding("fixture", "scale", _bind_right)]
    violations, ok = check_bindings(root, RecordingLibrary, binds)
    assert violations == [] and ok == 1


@pytest.mark.parametrize("bind", [_bind_short, _bind_kind], ids=["one-too-few", "wrong-kind"])
def test_fixture_binding_drifts_from_its_entry(tmp_path, bind):
    root = _fixture_root(tmp_path)
    violations, ok = check_bindings(root, RecordingLibrary, [Binding("fixture", "scale", bind)])
    assert _rules(violations) == {"BIND-ARITY"} and ok == 0
    assert "scale" in violations[0].message


def test_fixture_entry_unbound_and_binding_of_no_entry(tmp_path):
    root = _fixture_root(tmp_path)
    binds = [Binding("fixture", "gone", _bind_right)]
    violations, _ = check_bindings(root, RecordingLibrary, binds)
    assert _rules(violations) == {"BIND-ARITY"}
    assert {("gone" in v.message, "scale" in v.message) for v in violations} == {
        (True, False),
        (False, True),
    }


def test_fixture_argtypes_outside_a_registered_binding(tmp_path):
    root = _fixture_root(tmp_path, "def stray(lib):\n    lib.scale.argtypes = []\n")
    binds = [Binding("fixture", "scale", _bind_right)]
    violations, ok = check_bindings(root, RecordingLibrary, binds)
    assert _rules(violations) == {"BIND-ARITY"} and ok == 1
    assert "stray" in violations[0].message


def test_live_bindings_cover_every_c_entry_with_arguments():
    names = {(b.library, b.entry) for b in contracts.bindings()}
    entries = {
        (p.stem, e)
        for p in (ROOT / "src/repro_torch/csrc").glob("*.cu")
        for e, (kinds, _) in contracts.c_entries(p.read_text()).items()
        if kinds
    }
    assert names == entries and len(entries) == 12
    lib = contracts.recording_library("digest")
    assert lib.tree_digest_leaf_bytes() == ctypes.sizeof(importlib.import_module(
        "repro_torch.kernels.digest")._Leaf)  # fmt: skip


# ---------------------------------------------------------------------------
# STATE-INPLACE fixtures and the live entries on the CPU
# ---------------------------------------------------------------------------
def _state():
    return AcceptorState(torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32),
                         torch.zeros((8, 2), dtype=torch.int32))  # fmt: skip


def _in_place(stack, x):
    stack.rnd += x
    return stack, x


def _copy(stack, x):
    return AcceptorState(*(t.clone() for t in vars(stack).values())), x


def _rebind(stack, x):
    stack.rnd = stack.rnd + x
    return stack, x


def test_fixture_entry_in_place_is_clean():
    entry = _entry(_in_place, None, plain=_in_place, state_args=("stack",), reason="fixture")
    assert inplace_violations(entry, _state(), 1) == []


@pytest.mark.parametrize("fn", [_copy, _rebind], ids=["returns-a-copy", "rebinds-a-field"])
def test_fixture_entry_not_in_place(fn):
    entry = _entry(fn, None, plain=fn, state_args=("stack",), reason="fixture")
    violations = inplace_violations(entry, _state(), 1)
    assert _rules(violations) == {"STATE-INPLACE"}


@pytest.mark.parametrize(
    "shape", [dict(), dict(a=5, n=128, v=3, b=16, g=6, k=3)], ids=["small", "wider"]
)
def test_every_state_entry_is_in_place_on_the_cpu(shape):
    violations, ran = contracts.check_inplace(torch.device("cpu"), **shape)
    assert violations == [] and ran == 8
