"""The port's digest and seal fold against the reference's, bit for bit.

``repro_torch.kernels.ops.digest``/``tree_digest`` on CPU tensors (the plain
fold) against ``repro.kernels.digest`` in interpret mode and
``repro.kernels.ref.digest``: int32 and float32 leaves, lengths that are not
a multiple of the reference kernel's block, and the empty seal.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import snapshot as rsnap  # noqa: E402
from repro.kernels import digest as rdigest  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.core import snapshot as tsnap  # noqa: E402
from repro_torch.kernels import digest as tdigest  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

# the reference kernel's block is 32 Ki elements: lengths below, at and
# across it, odd ones included
LENGTHS = [1, 7, 1000, 32 * 1024, 32 * 1024 + 5, 70_001]


def _leaf(rng, n: int, dtype: str) -> np.ndarray:
    if dtype == "int32":
        return rng.integers(-(2**31), 2**31, n, dtype=np.int32)
    return rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("n", LENGTHS)
def test_digest_matches_reference(n, dtype):
    x = _leaf(np.random.default_rng([n, len(dtype)]), n, dtype)
    got = int(tops.digest(torch.from_numpy(x)))
    assert got == int(rref.digest(jnp.asarray(x)))
    assert got == int(rdigest.digest(jnp.asarray(x), interpret=True))


def test_digest_of_a_2d_leaf_is_its_flat_fold():
    x = np.random.default_rng(1).integers(-(2**31), 2**31, (300, 16), dtype=np.int32)
    assert int(tops.digest(torch.from_numpy(x))) == int(rref.digest(jnp.asarray(x)))


@pytest.mark.parametrize("dtype", [torch.int16, torch.float16, torch.int64, torch.float64])
def test_digest_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError):
        tops.digest(torch.zeros(8, dtype=dtype))
    with pytest.raises(TypeError):
        tdigest.digest_plain(torch.zeros(8, dtype=dtype))


def test_digest_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tdigest.digest(torch.zeros(8, dtype=torch.int32))


@pytest.mark.parametrize("seed", range(3))
def test_tree_digest_matches_reference(seed):
    rng = np.random.default_rng([seed, 9])
    leaves = [_leaf(rng, int(rng.integers(1, 5000)), d) for d in ("int32", "float32", "int32")]
    leaves.append(rng.integers(-(2**31), 2**31, (77, 16), dtype=np.int32))
    want = int(rdigest.tree_digest([jnp.asarray(x) for x in leaves], interpret=True))
    assert tops.tree_digest([torch.from_numpy(x) for x in leaves]) == want


def test_seal_matches_reference_and_empty_seals_to_zero():
    rng = np.random.default_rng(5)
    insts = np.sort(rng.choice(10_000, 700, replace=False)).astype(np.int32)
    values = rng.integers(-(2**31), 2**31, (700, 16), dtype=np.int32)
    assert tsnap._seal(insts, values, "cpu") == rsnap._seal(insts, values)
    empty = (np.zeros((0,), np.int32), np.zeros((0, 16), np.int32))
    assert tsnap._seal(*empty, "cpu") == rsnap._seal(*empty) == 0
    assert tops.tree_digest([]) == 0
