"""K1, the fused CAANS wire path, K5, its persistent K-round form, K6, the
packed shard round, and K2, the staged vote of the acceptor array: CUDA
kernels.

``wirepath_round`` and ``cohort_wirepath_round`` launch the two entries of
``csrc/wirepath.cu``, which replaces the TPU kernel
``repro.kernels.wirepath.cohort_wirepath_round``: one complete Phase-2
round (sequencing, the vote of all A acceptors, the learner quorum and the
ring dedup) in one launch, with the six state tensors updated in place.
``wirepath_round`` serves one group; its plain version is
``repro_torch.core.batched.fused_round``.  ``cohort_wirepath_round`` serves
the groups of the blocks ``gsel`` selects in ``(G, ...)`` slabs, and
``multigroup_wirepath_round`` is its every-block slice; their plain
versions are ``batched.cohort_fused_round`` and
``batched.multigroup_fused_round``.  ``kernels.ops`` chooses between kernel
and plain version by the device of the tensors.

K1, K5 and K6 run one lane body: a team of threads per lane that loads
first, stores 16 bytes a thread where it can and spreads over the SMs
(``csrc/wirepath.cu``'s header).  ``lane_geometry`` chooses on the host the
variant (``vector``: int4 words, where V % 4 == 0 and the value tensors
start on 16 bytes; ``scalar`` otherwise), the team size, the block and the
grid (``wave_geometry`` K5's 3-D grid) for every team kernel: these, K2,
K7 (``kernels.acceptor``) and K8 (``kernels.learner``);
``vector_launches`` and ``scalar_launches`` count the launches of each
variant of all six.  K1 takes any window base: each lane computes
its own ring slot, so there is no block-alignment precondition, and
``group_block`` (the TPU kernel's group fold) changes no result.  It
requires ``B <= N`` (distinct slots, so in-place writes never race),
``A <= 8`` and, in cohort form, distinct selected blocks (checked here).

``persistent_wirepath_round`` launches the K5 entry of the same source,
which replaces the TPU kernel ``repro.kernels.wirepath.persistent_wirepath_round``:
K rounds of the cohort form in one launch, driven by the wave descriptor
``wni``/``wen`` (each group's window base and participation per round).
Its plain version is ``batched.persistent_cohort_rounds``.  One team
serves one (round, row, lane), the rounds spread over the grid, which is
race-free only when ``K * B <= N`` and each selected group's bases walk by
``B`` over its enabled rounds; both are checked here, on the host, before
the launch.

``shard_slab_round`` is K1's shard slice, replacing the reference's
``shard_slab_round``: the cohort entry over every block of one shard's
``(Gl, ...)`` slab view, the replicated per-group vectors sliced at the
shard's offset; its plain version is ``batched.shard_slab_round``.
``packed_shard_round`` launches K6, the ``packed_shard_round`` entry of the
same source, which replaces the TPU kernel
``repro.kernels.wirepath.packed_shard_round``: one round over a shard's
packed lane table, lane ``j`` on slab row ``segids[j]`` with its own
scalars, pads inert; its plain version is ``batched.packed_multigroup_round``.
Enabled lanes must name distinct rows and ``C <= Gl``, checked on the host
(``check_packed_lanes``) before the launch.  Each has its own launch count.

``acceptor_vote_all_window`` launches the ``acceptor_vote_all`` entry point
of ``csrc/vote.cu``, which replaces the TPU kernel
``repro.kernels.wirepath.acceptor_vote_all_window``: the staged Phase-2
vote of all A acceptors on one batch of headers, the stacked rings updated
in place, one ``(A, B)`` vote batch per field.  Its plain version is
``repro_torch.core.batched.acceptor_phase2_all``.  Lane j addresses slot
``inst[j] mod N``, so every Phase-2 batch the dataplane votes (sequenced
bursts, the software coordinator's, recovery and takeover windows) runs on
it at any base.  Precondition, as the plain engine's: the batch's slots are
pairwise distinct (so ``B <= N``, which is checked).  A team of threads
serves one (acceptor, lane), as K1's team serves a lane, on a (lane blocks,
A) grid; the variant comes from V and the ``data_ptr() % 16`` of the
burst, ``st_val`` and the vote values.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..analysis.contracts import Binding
from ..core.plan import DEFAULT_BLOCK_B
from . import _build

MAX_A = 8
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1
# threads per block of the team kernels K1, K5, K6, K2, K7 and K8 (whole
# teams), chosen on the card (PERF.md section 6); read at each launch
LANE_THREADS = 128
MAX_GRID_YZ = 65_535  # a grid's y and z extents at most

# launches of K1 (single group, cohort form, shard slice), K6, K5 and K2 in
# this process, and of the two variants of every team kernel (these, K7
# and K8); reset by whoever reads them
launches = 0
cohort_launches = 0
shard_launches = 0
packed_launches = 0
persistent_launches = 0
vote_all_launches = 0
vector_launches = 0
scalar_launches = 0


def _bind_round(lib, entry: str):
    fn = getattr(lib, entry)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, *[i] * 6, *[p] * 12, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _bind_cohort(lib, entry: str):
    fn = getattr(lib, entry)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, *[p] * 5, *[i] * 6, *[p] * 10, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _bind_packed(lib, entry: str):
    fn = getattr(lib, entry)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [*[p] * 6, *[i] * 7, *[p] * 10, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _bind_persistent(lib, entry: str):
    fn = getattr(lib, entry)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, p, p, p, p, p, *[i] * 7, *[p] * 10, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _bind_floor(lib, entry: str):
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bind_vote(lib, entry: str):
    fn = getattr(lib, entry)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, i, i, *[p] * 13, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


BINDINGS = (
    Binding("wirepath", "wirepath_round", _bind_round),
    Binding("wirepath", "cohort_wirepath_round", _bind_cohort),
    Binding("wirepath", "packed_shard_round", _bind_packed),
    Binding("wirepath", "persistent_wirepath_round", _bind_persistent),
    Binding("wirepath", "launch_floor", _bind_floor),
    Binding("vote", "acceptor_vote_all", _bind_vote),
)

_fns: dict = {}  # entry name -> its typed ctypes function


def _kernel(entry: str):
    fn = _fns.get(entry)
    if fn is None:
        fn = _fns[entry] = next(b for b in BINDINGS if b.entry == entry).load(_build.library)
    return fn


def launch_floor():
    """``csrc/wirepath.cu``'s empty kernel, typed: ``launch_floor(gx, gy,
    gz, threads, stream)`` launches it on that grid and block, the floor
    under a launch of that shape that ``chip_smoke.py`` times."""
    return _kernel("launch_floor")


@dataclass(frozen=True)
class LaneGeometry:
    """How a team kernel launches: the variant, threads per lane (``team``),
    threads per block and the grid, ``(x, y)`` or K5's ``(x, y, z)``."""

    variant: str  # "vector" (int4 words) or "scalar" (int32 words)
    team: int
    block: int
    grid: tuple[int, ...]


def lane_geometry(v: int, b: int, rows: int, aligned: bool) -> LaneGeometry:
    """The launch of a round of ``rows`` rows of ``b`` lanes of ``v`` value
    words: the vector variant where ``v % 4 == 0`` and the value tensors are
    ``aligned`` on 16 bytes, else the scalar one; a team of the power of two
    at or above the lane's words (int4 or int32), at most 32, so it divides
    a warp; blocks of ``LANE_THREADS`` (a multiple of 32), ``LANE_THREADS //
    team`` lanes each."""
    threads = LANE_THREADS
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"team kernels take blocks of whole warps up to 1024, got {threads}")
    vector = aligned and v % 4 == 0
    words = v // 4 if vector else v
    team = min(32, 1 << (words - 1).bit_length())
    lanes = threads // team
    return LaneGeometry("vector" if vector else "scalar", team, threads, (-(-b // lanes), rows))


def wave_geometry(v: int, b: int, rows: int, k: int, n: int, aligned: bool) -> LaneGeometry:
    """K5's launch of a wave of ``k`` rounds over ``rows`` rows of ``b``
    lanes: ``lane_geometry``'s variant, team, block and ``(x, rows)``, and
    a z extent of one round a block, capped at 65,535; above the cap block
    z serves rounds z, z + 65,535, ...  Raises where the wave would lap the
    ``n``-slot ring (``K * B > N``) or the grid cannot hold the rows."""
    if k < 1 or k * b > n or not 1 <= rows <= MAX_GRID_YZ:
        raise ValueError(
            f"persistent_wirepath_round needs 1 <= K, K * B <= N and 1 <= rows <= "
            f"{MAX_GRID_YZ}, got K={k}, B={b}, N={n}, rows={rows}"
        )
    geo = lane_geometry(v, b, rows, aligned)
    return LaneGeometry(geo.variant, geo.team, geo.block, (*geo.grid, min(k, MAX_GRID_YZ)))


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _lanes(v: int, b: int, rows: int, *tensors: torch.Tensor) -> LaneGeometry:
    """``lane_geometry`` for these value tensors: for K1 and K6 st_val, lval,
    the burst and the value output; for K2 (rows = A) and K7 (rows = 1) the
    burst, st_val and the vote values; for K8 (rows = 1) the vote values
    and the value output."""
    return lane_geometry(v, b, rows, _aligned(*tensors))


def _launched(geo: LaneGeometry, rc: int, what: str) -> None:
    """Raise on a refused launch of a team kernel, else count it under its
    variant."""
    global vector_launches, scalar_launches
    _build.check(rc, what)
    if geo.variant == "vector":
        vector_launches += 1
    else:
        scalar_launches += 1


def vote_io(
    what: str,
    lead: tuple,
    n: int,
    msgtype: torch.Tensor,
    inst: torch.Tensor,
    msg_rnd: torch.Tensor,
    msg_val: torch.Tensor,
) -> list[torch.Tensor]:
    """Check a Phase-2 batch for a vote kernel (K2, K7) and allocate its
    votes: five int32 ``lead + (B,)`` fields (type, inst, rnd, vrnd, swid)
    and the ``lead + (B, V)`` values.  ``B <= N`` keeps the lanes' slots
    distinct for a contiguous window; the kernels need distinct slots in
    general."""
    dev = msg_val.device
    _build.on_card(what, dev)
    b, v = msg_val.shape
    if not 1 <= b <= n:
        raise ValueError(f"{what} needs 1 <= B <= N, got B={b}, N={n}")
    for name, t in (("msgtype", msgtype), ("inst", inst), ("rnd", msg_rnd)):
        _build.require(what, name, t, torch.int32, (b,), dev)
    _build.require(what, "value", msg_val, torch.int32, (b, v), dev)
    fields = torch.empty((5, *lead, b), dtype=torch.int32, device=dev).unbind(0)
    return [*fields, torch.empty((*lead, b, v), dtype=torch.int32, device=dev)]


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, dev: torch.device):
    _build.require("wirepath_round", name, t, dtype, shape, dev)


def wirepath_round(
    next_inst: torch.Tensor,  # int32[]  window base
    crnd: torch.Tensor,  # int32[]  coordinator round
    quorum: int,
    alive: torch.Tensor,  # bool[A]
    st_rnd: torch.Tensor,  # int32[A, N]  stacked acceptor rings, in place
    st_vrnd: torch.Tensor,  # int32[A, N]
    st_val: torch.Tensor,  # int32[A, N, V]
    ldel: torch.Tensor,  # int32[N]  learner ring, in place
    linst: torch.Tensor,  # int32[N]
    lval: torch.Tensor,  # int32[N, V]
    values: torch.Tensor,  # int32[B, V]  burst values
    limit: int | None = None,  # first refused instance; None = no reclamation
) -> tuple[torch.Tensor, ...]:
    """One fused Phase-2 round on the card.  Returns ``(st_rnd, st_vrnd,
    st_val, ldel, linst, lval, next_inst', inst[B], fresh[B], win_vrnd[B],
    value[B, V])``: the six state tensors are the inputs, updated in place;
    ``next_inst'`` is the advanced watermark ``next_inst + B`` (a new
    tensor), ``inst`` the lanes' instances and ``fresh`` a bool mask."""
    global launches
    dev = values.device
    _build.on_card("wirepath_round", dev)
    a, n = st_rnd.shape
    b, v = values.shape
    if not 1 <= a <= MAX_A or b > n:
        raise ValueError(f"wirepath_round needs 1 <= A <= {MAX_A} and B <= N, got {a}, {b}, {n}")
    i32 = torch.int32
    _check("next_inst", next_inst, i32, (), dev)
    _check("crnd", crnd, i32, (), dev)
    _check("alive", alive, torch.bool, (a,), dev)
    _check("st_rnd", st_rnd, i32, (a, n), dev)
    _check("st_vrnd", st_vrnd, i32, (a, n), dev)
    _check("st_val", st_val, i32, (a, n, v), dev)
    _check("ldel", ldel, i32, (n,), dev)
    _check("linst", linst, i32, (n,), dev)
    _check("lval", lval, i32, (n, v), dev)
    _check("values", values, i32, (b, v), dev)
    lim = INT32_MAX if limit is None else int(limit)
    if not INT32_MIN <= lim <= INT32_MAX:
        # a C int would wrap it and refuse every lane in silence
        raise OverflowError(f"wirepath_round: limit {lim} is outside int32")
    next_out = torch.empty((), dtype=i32, device=dev)
    inst = torch.empty((b,), dtype=i32, device=dev)
    fresh = torch.empty((b,), dtype=torch.bool, device=dev)
    win = torch.empty((b,), dtype=i32, device=dev)
    value = torch.empty((b, v), dtype=i32, device=dev)
    fn = _kernel("wirepath_round")
    geo = _lanes(v, b, 1, st_val, lval, values, value)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            next_inst.data_ptr(), crnd.data_ptr(), alive.data_ptr(),
            int(quorum), lim, a, n, v, b,
            st_rnd.data_ptr(), st_vrnd.data_ptr(), st_val.data_ptr(),
            ldel.data_ptr(), linst.data_ptr(), lval.data_ptr(),
            values.data_ptr(), next_out.data_ptr(), inst.data_ptr(),
            fresh.data_ptr(), win.data_ptr(), value.data_ptr(),
            geo.variant == "vector", geo.team, geo.block, stream,
        )  # fmt: skip
    _launched(geo, rc, "wirepath_round launch")
    launches += 1
    return st_rnd, st_vrnd, st_val, ldel, linst, lval, next_out, inst, fresh, win, value


def _host_gsel(gsel, n_blocks: int) -> np.ndarray:
    """The selected group blocks as host int32, checked distinct and in
    range: two rows on one group would race in place."""
    gs = gsel.cpu().numpy() if isinstance(gsel, torch.Tensor) else np.asarray(gsel)
    gs = gs.astype(np.int64).reshape((-1,))
    if gs.size == 0 or len(set(gs.tolist())) != gs.size or gs.min() < 0 or gs.max() >= n_blocks:
        raise ValueError(
            f"cohort_wirepath_round: gsel {gs.tolist()} must be distinct blocks in [0, {n_blocks})"
        )
    return gs.astype(np.int32)


def cohort_wirepath_round(
    gsel,  # int[NB]  selected group blocks (host sequence or tensor)
    next_inst: torch.Tensor,  # int32[G]  per-group window base
    crnd: torch.Tensor,  # int32[G]  per-group coordinator round
    quorum: int,
    alive: torch.Tensor,  # bool[G, A]
    st_rnd: torch.Tensor,  # int32[G, A, N]  stacked acceptor rings, in place
    st_vrnd: torch.Tensor,  # int32[G, A, N]
    st_val: torch.Tensor,  # int32[G, A, N, V]
    ldel: torch.Tensor,  # int32[G, N]  learner rings, in place
    linst: torch.Tensor,  # int32[G, N]
    lval: torch.Tensor,  # int32[G, N, V]
    values: torch.Tensor,  # int32[NB*GB, B, V]  compact cohort burst
    enabled: torch.Tensor | None = None,  # int32[G] 0/1; None = all
    limit: torch.Tensor | None = None,  # int32[G] first refused inst; None = none
    *,
    group_block: int = 1,
) -> tuple[torch.Tensor, ...]:
    """One fused Phase-2 round for the groups of the selected blocks, on the
    card.  Row ``j*GB + k`` of ``values`` and of the outputs belongs to
    group ``gsel[j]*GB + k``; a member that is not enabled rides inert.
    ``limit`` is a device vector, so a limit that wrapped past int32 max
    stays wrapped and refuses its group's lanes, as the reference's does.
    Returns ``(st_rnd, st_vrnd, st_val, ldel, linst, lval, fresh[C, B],
    win_vrnd[C, B], value[C, B, V])``: the six state tensors are the inputs,
    updated in place; ``fresh`` is a bool mask."""
    global cohort_launches
    out = _cohort_checked(
        "cohort_wirepath_round", gsel, next_inst, crnd, quorum, alive,
        st_rnd, st_vrnd, st_val, ldel, linst, lval, values, enabled, limit, group_block,
    )  # fmt: skip
    cohort_launches += 1
    return out


def _cohort_checked(
    what: str,
    gsel, next_inst, crnd, quorum, alive, st_rnd, st_vrnd, st_val, ldel, linst, lval, values,
    enabled: torch.Tensor | None,
    limit: torch.Tensor | None,
    gb: int,
) -> tuple[torch.Tensor, ...]:
    """``cohort_wirepath_round``'s checks, then the launch; the caller
    counts the launch under its own name."""
    dev = values.device
    _build.on_card(what, dev)
    g, a, n = st_rnd.shape
    c, b, v = values.shape
    if not 1 <= a <= MAX_A or b > n or gb < 1 or g % gb:
        raise ValueError(
            f"{what} needs 1 <= A <= {MAX_A}, B <= N and GB | G, got {a}, {b}, {n}, {gb}, {g}"
        )
    gs = _host_gsel(gsel, g // gb)
    if c != gs.size * gb:
        raise ValueError(f"{what}: {c} burst rows for {gs.size} blocks of {gb}")
    i32 = torch.int32
    if enabled is None:
        enabled = torch.ones((g,), dtype=i32, device=dev)
    if limit is None:
        limit = torch.full((g,), INT32_MAX, dtype=i32, device=dev)
    for name, t, dtype, shape in (
        ("next_inst", next_inst, i32, (g,)),
        ("crnd", crnd, i32, (g,)),
        ("limit", limit, i32, (g,)),
        ("alive", alive, torch.bool, (g, a)),
        ("enabled", enabled, i32, (g,)),
        ("st_rnd", st_rnd, i32, (g, a, n)),
        ("st_vrnd", st_vrnd, i32, (g, a, n)),
        ("st_val", st_val, i32, (g, a, n, v)),
        ("ldel", ldel, i32, (g, n)),
        ("linst", linst, i32, (g, n)),
        ("lval", lval, i32, (g, n, v)),
        ("values", values, i32, (c, b, v)),
    ):
        _build.require(what, name, t, dtype, shape, dev)
    return _cohort_launch(
        torch.from_numpy(gs).to(dev), gb, next_inst, crnd, quorum, alive,
        st_rnd, st_vrnd, st_val, ldel, linst, lval, values, enabled, limit,
    )  # fmt: skip


def _cohort_launch(
    gsel: torch.Tensor,  # int32[NB] on the card, checked by the caller
    gb: int,
    next_inst, crnd, quorum, alive, st_rnd, st_vrnd, st_val, ldel, linst, lval, values,
    enabled: torch.Tensor,
    limit: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """Launch the cohort entry on checked inputs (CUDA-graph capturable:
    no host copy).  ``cohort_wirepath_round`` is the checked wrapper; its
    callers count the launches."""
    g, a, n = st_rnd.shape
    c, b, v = values.shape
    dev = values.device
    fresh = torch.empty((c, b), dtype=torch.bool, device=dev)
    win = torch.empty((c, b), dtype=torch.int32, device=dev)
    value = torch.empty((c, b, v), dtype=torch.int32, device=dev)
    fn = _kernel("cohort_wirepath_round")
    geo = _lanes(v, b, c, st_val, lval, values, value)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            gsel.data_ptr(), gsel.numel(), gb,
            next_inst.data_ptr(), crnd.data_ptr(), limit.data_ptr(),
            alive.data_ptr(), enabled.data_ptr(),
            int(quorum), g, a, n, v, b,
            st_rnd.data_ptr(), st_vrnd.data_ptr(), st_val.data_ptr(),
            ldel.data_ptr(), linst.data_ptr(), lval.data_ptr(),
            values.data_ptr(), fresh.data_ptr(), win.data_ptr(), value.data_ptr(),
            geo.variant == "vector", geo.team, geo.block, stream,
        )  # fmt: skip
    _launched(geo, rc, "cohort_wirepath_round launch")
    return st_rnd, st_vrnd, st_val, ldel, linst, lval, fresh, win, value


def multigroup_wirepath_round(
    next_inst: torch.Tensor,  # int32[G]
    crnd: torch.Tensor,  # int32[G]
    quorum: int,
    alive: torch.Tensor,  # bool[G, A]
    st_rnd: torch.Tensor,  # int32[G, A, N]
    st_vrnd: torch.Tensor,  # int32[G, A, N]
    st_val: torch.Tensor,  # int32[G, A, N, V]
    ldel: torch.Tensor,  # int32[G, N]
    linst: torch.Tensor,  # int32[G, N]
    lval: torch.Tensor,  # int32[G, N, V]
    values: torch.Tensor,  # int32[G, B, V]
    enabled: torch.Tensor | None = None,
    limit: torch.Tensor | None = None,
    *,
    group_block: int = 1,
) -> tuple[torch.Tensor, ...]:
    """One fused Phase-2 round for all G groups: the every-block slice of
    ``cohort_wirepath_round`` (``gsel = arange(G // GB)``), whose compact
    rows are the ``(G, ...)`` layout."""
    return cohort_wirepath_round(
        range(st_rnd.shape[0] // group_block), next_inst, crnd, quorum, alive,
        st_rnd, st_vrnd, st_val, ldel, linst, lval, values, enabled, limit,
        group_block=group_block,
    )  # fmt: skip


def shard_slab_round(
    group_offset: int,  # first global group id of this slab
    next_inst: torch.Tensor,  # int32[G_global]  replicated watermarks
    crnd: torch.Tensor,  # int32[G_global]
    quorum: int,
    alive: torch.Tensor,  # bool[G_global, A]
    st_rnd: torch.Tensor,  # int32[Gl, A, N]  this shard's acceptor slab, in place
    st_vrnd: torch.Tensor,  # int32[Gl, A, N]
    st_val: torch.Tensor,  # int32[Gl, A, N, V]
    ldel: torch.Tensor,  # int32[Gl, N]  this shard's learner slab, in place
    linst: torch.Tensor,  # int32[Gl, N]
    lval: torch.Tensor,  # int32[Gl, N, V]
    values: torch.Tensor,  # int32[Gl, B, V]  this shard's burst slab
    enabled: torch.Tensor | None = None,  # int32[G_global] 0/1; None = all
    limit: torch.Tensor | None = None,  # int32[G_global]; None = none
    *,
    group_block: int = 1,
) -> tuple[torch.Tensor, ...]:
    """K1's shard slice, replacing the reference's ``shard_slab_round``:
    one fused Phase-2 round over one shard's contiguous ``(Gl, ...)`` slab,
    on the card.  The per-group vectors stay global and replicated;
    ``group_offset`` selects the shard's window of them (views, no copy),
    and the round runs on K1's cohort entry over every block of the slab.
    Returns what ``multigroup_wirepath_round`` returns for the slab."""
    global shard_launches
    what = "shard_slab_round"
    gl, g = st_rnd.shape[0], next_inst.shape[0]
    if not 0 <= group_offset <= g - gl or group_block < 1 or gl % group_block:
        raise ValueError(
            f"{what}: a slab of {gl} at offset {group_offset} of {g} groups, "
            f"group_block {group_block} must divide it"
        )
    sl = slice(group_offset, group_offset + gl)
    out = _cohort_checked(
        what, range(gl // group_block), next_inst[sl], crnd[sl], quorum, alive[sl],
        st_rnd, st_vrnd, st_val, ldel, linst, lval, values,
        None if enabled is None else enabled[sl], None if limit is None else limit[sl],
        group_block,
    )  # fmt: skip
    shard_launches += 1
    return out


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def check_packed_lanes(
    what: str, segids, enabled, gl: int, c: int, b: int, n: int, block_b: int
) -> None:
    """The packed round's preconditions, on the host: ``C <= Gl``,
    ``B <= N``, the launch block (``block_b`` capped at B) divides B and N,
    and the enabled lanes name pairwise-distinct rows in ``[0, Gl)``; pads
    (``enabled == 0``) may name any row.  Raises otherwise: two lanes on one
    row would race in place."""
    bb = min(block_b, b)
    if c > gl or b > n or not 1 <= bb <= 1024 or b % bb or n % bb:
        raise ValueError(
            f"{what} needs C <= Gl, B <= N and a block (block_b capped at B) dividing B "
            f"and N, got C={c}, Gl={gl}, B={b}, N={n}, block_b={block_b}"
        )
    seg = _host(segids).astype(np.int64).reshape((-1,))
    en = _host(enabled).reshape((-1,)) != 0
    if seg.shape != (c,) or en.shape != (c,):
        raise ValueError(f"{what}: segids {seg.shape} and enabled {en.shape} must be ({c},)")
    rows = seg[en]
    if len(set(rows.tolist())) != rows.size or (rows.size and (rows.min() < 0 or rows.max() >= gl)):
        raise ValueError(
            f"{what}: enabled lanes must name distinct rows in [0, {gl}), got {rows.tolist()}"
        )


def packed_shard_round(
    segids: torch.Tensor,  # int32[C]  per-lane slab row
    next_inst: torch.Tensor,  # int32[C]  per-lane window base
    crnd: torch.Tensor,  # int32[C]  per-lane round
    quorum: int,
    alive: torch.Tensor,  # int32[C, A]  per-lane liveness, 0/1
    st_rnd: torch.Tensor,  # int32[Gl, A, N]  this shard's acceptor slab, in place
    st_vrnd: torch.Tensor,  # int32[Gl, A, N]
    st_val: torch.Tensor,  # int32[Gl, A, N, V]
    ldel: torch.Tensor,  # int32[Gl, N]  this shard's learner slab, in place
    linst: torch.Tensor,  # int32[Gl, N]
    lval: torch.Tensor,  # int32[Gl, N, V]
    values: torch.Tensor,  # int32[C, B, V]  packed burst, lane order
    enabled: torch.Tensor | None = None,  # int32[C] 0/1; None = every lane real
    limit: torch.Tensor | None = None,  # int32[C]; None = no reclamation
    *,
    block_b: int = DEFAULT_BLOCK_B,
    lanes_host: tuple[np.ndarray, np.ndarray] | None = None,
) -> tuple[torch.Tensor, ...]:
    """K6, replacing the reference's ``packed_shard_round``: one fused
    Phase-2 round over a shard's packed lane table, on the card.  Lane
    ``j`` serves slab row ``segids[j]`` with its own watermark, round,
    liveness and limit; a pad lane (``enabled == 0``) touches no row and
    gives fresh 0, win NO_ROUND, value 0.  The per-lane tables are device
    tensors; the host checks of ``check_packed_lanes`` read ``lanes_host``
    (host copies of ``segids`` and ``enabled``) where the caller has them,
    else copy the two tables back.  ``block_b`` is the reference kernel's
    batch block, checked as the reference checks it: it changes no result
    and shapes no launch here.  Returns
    ``(st_rnd, st_vrnd, st_val, ldel, linst, lval, fresh[C, B], win_vrnd[C,
    B], value[C, B, V])``: the six state tensors are the inputs, updated in
    place; ``fresh`` is a bool mask."""
    what = "packed_shard_round"
    dev = values.device
    _build.on_card(what, dev)
    gl, a, n = st_rnd.shape
    c, b, v = values.shape
    if not 1 <= a <= MAX_A:
        raise ValueError(f"{what} needs 1 <= A <= {MAX_A}, got {a}")
    i32 = torch.int32
    if enabled is None:
        enabled = torch.ones((c,), dtype=i32, device=dev)
    if limit is None:
        limit = torch.full((c,), INT32_MAX, dtype=i32, device=dev)
    seg_h, en_h = lanes_host if lanes_host is not None else (segids, enabled)
    check_packed_lanes(what, seg_h, en_h, gl, c, b, n, block_b)
    for name, t, dtype, shape in (
        ("segids", segids, i32, (c,)),
        ("next_inst", next_inst, i32, (c,)),
        ("crnd", crnd, i32, (c,)),
        ("limit", limit, i32, (c,)),
        ("alive", alive, i32, (c, a)),
        ("enabled", enabled, i32, (c,)),
        ("st_rnd", st_rnd, i32, (gl, a, n)),
        ("st_vrnd", st_vrnd, i32, (gl, a, n)),
        ("st_val", st_val, i32, (gl, a, n, v)),
        ("ldel", ldel, i32, (gl, n)),
        ("linst", linst, i32, (gl, n)),
        ("lval", lval, i32, (gl, n, v)),
        ("values", values, i32, (c, b, v)),
    ):
        _build.require(what, name, t, dtype, shape, dev)
    global packed_launches
    out = _packed_launch(
        segids, next_inst, crnd, limit, alive, enabled, quorum,
        st_rnd, st_vrnd, st_val, ldel, linst, lval, values,
    )  # fmt: skip
    packed_launches += 1
    return out


def _packed_launch(
    segids, next_inst, crnd, limit, alive, enabled, quorum,
    st_rnd, st_vrnd, st_val, ldel, linst, lval, values,
) -> tuple[torch.Tensor, ...]:
    """Launch K6 on checked inputs (CUDA-graph capturable: no host copy).
    ``packed_shard_round`` is the checked wrapper and counts the launch."""
    gl, a, n = st_rnd.shape
    c, b, v = values.shape
    dev = values.device
    fresh = torch.empty((c, b), dtype=torch.bool, device=dev)
    win = torch.empty((c, b), dtype=torch.int32, device=dev)
    value = torch.empty((c, b, v), dtype=torch.int32, device=dev)
    fn = _kernel("packed_shard_round")
    geo = _lanes(v, b, c, st_val, lval, values, value)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            segids.data_ptr(), next_inst.data_ptr(), crnd.data_ptr(), limit.data_ptr(),
            alive.data_ptr(), enabled.data_ptr(),
            int(quorum), c, gl, a, n, v, b,
            st_rnd.data_ptr(), st_vrnd.data_ptr(), st_val.data_ptr(),
            ldel.data_ptr(), linst.data_ptr(), lval.data_ptr(),
            values.data_ptr(), fresh.data_ptr(), win.data_ptr(), value.data_ptr(),
            geo.variant == "vector", geo.team, geo.block, stream,
        )  # fmt: skip
    _launched(geo, rc, "packed_shard_round launch")
    return st_rnd, st_vrnd, st_val, ldel, linst, lval, fresh, win, value


def _host_wave(wni, wen, b: int, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The wave descriptor as host int32 ``(K, G)`` arrays (``wen`` as 0/1),
    checked: every group of the selected blocks walks ``wni[k+1] = wni[k]
    + B * wen[k]`` (int32 wrap).  K5's threads do not synchronise, and that
    walk with ``K * B <= N`` is what keeps them off each other's slots."""

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    ni = host(wni).astype(np.int64)
    en = (host(wen) != 0).astype(np.int64)
    if ni.shape != en.shape or ni.ndim != 2:
        raise ValueError(f"persistent_wirepath_round: wni {ni.shape} and wen {en.shape} differ")
    walk = (ni[:-1, rows] + b * en[:-1, rows] - INT32_MIN) % 2**32 + INT32_MIN
    if not np.array_equal(walk, ni[1:, rows]):
        raise ValueError(
            "persistent_wirepath_round: wni must walk wni[k+1] = wni[k] + B * wen[k] "
            "for every group of the selected blocks"
        )
    return ni.astype(np.int32), en.astype(np.int32)


def persistent_wirepath_round(
    gsel,  # int[NB]  selected group blocks (host sequence or tensor)
    wni,  # int32[K, G]  per-round window bases (host array or tensor)
    wen,  # int32[K, G]  per-round participation, 0/1 (host array or tensor)
    crnd: torch.Tensor,  # int32[G]  per-group coordinator round
    quorum: int,
    alive: torch.Tensor,  # bool[G, A]
    st_rnd: torch.Tensor,  # int32[G, A, N]  stacked acceptor rings, in place
    st_vrnd: torch.Tensor,  # int32[G, A, N]
    st_val: torch.Tensor,  # int32[G, A, N, V]
    ldel: torch.Tensor,  # int32[G, N]  learner rings, in place
    linst: torch.Tensor,  # int32[G, N]
    lval: torch.Tensor,  # int32[G, N, V]
    values: torch.Tensor,  # int32[K, NB*GB, B, V]  compact wave values
    limit: torch.Tensor | None = None,  # int32[G] first refused inst; None = none
    *,
    block_b: int = DEFAULT_BLOCK_B,
    group_block: int = 1,
) -> tuple[torch.Tensor, ...]:
    """K fused Phase-2 rounds for the groups of the selected blocks in one
    launch, on the card.  Row ``j*GB + k`` of ``values[r]`` and of the
    round-``r`` outputs belongs to group ``gsel[j]*GB + k``, served at
    ``wni[r, g]``; a group with ``wen[r, g] == 0`` rides round ``r`` inert.
    ``block_b`` is the reference kernel's batch block: checked (capped at
    B, it must lie in [1, 1024]), it changes no result and shapes no launch
    here (blocks are ``LANE_THREADS`` threads of whole teams, as K1's).
    Returns ``(st_rnd, st_vrnd, st_val, ldel, linst, lval,
    fresh[K, C, B], win_vrnd[K, C, B], value[K, C, B, V])``: the six state
    tensors are the inputs, updated in place; ``fresh`` is a bool mask."""
    what = "persistent_wirepath_round"
    dev = values.device
    _build.on_card(what, dev)
    g, a, n = st_rnd.shape
    k, c, b, v = values.shape
    gb, bb = group_block, min(block_b, b)
    if not 1 <= a <= MAX_A or k * b > n or gb < 1 or g % gb or not 1 <= bb <= 1024:
        raise ValueError(
            f"{what} needs 1 <= A <= {MAX_A}, K * B <= N, GB | G and 1 <= block_b <= 1024, "
            f"got A={a}, K={k}, B={b}, N={n}, GB={gb}, G={g}, block_b={block_b}"
        )
    gs = _host_gsel(gsel, g // gb)
    if c != gs.size * gb:
        raise ValueError(f"{what}: {c} wave rows for {gs.size} blocks of {gb}")
    rows = (gs.astype(np.int64)[:, None] * gb + np.arange(gb)[None, :]).reshape(-1)
    ni, en = _host_wave(wni, wen, b, rows)
    if ni.shape != (k, g):
        raise ValueError(f"{what}: wni and wen must be ({k}, {g}), got {ni.shape}")
    i32 = torch.int32
    if limit is None:
        limit = torch.full((g,), INT32_MAX, dtype=i32, device=dev)
    for name, t, dtype, shape in (
        ("crnd", crnd, i32, (g,)),
        ("limit", limit, i32, (g,)),
        ("alive", alive, torch.bool, (g, a)),
        ("st_rnd", st_rnd, i32, (g, a, n)),
        ("st_vrnd", st_vrnd, i32, (g, a, n)),
        ("st_val", st_val, i32, (g, a, n, v)),
        ("ldel", ldel, i32, (g, n)),
        ("linst", linst, i32, (g, n)),
        ("lval", lval, i32, (g, n, v)),
        ("values", values, i32, (k, c, b, v)),
    ):
        _build.require(what, name, t, dtype, shape, dev)
    gsel_d, wni_d, wen_d = (torch.from_numpy(x).to(dev) for x in (gs, ni, en))
    return _persistent_launch(
        gsel_d, gb, wni_d, wen_d, crnd, quorum, alive,
        st_rnd, st_vrnd, st_val, ldel, linst, lval, values, limit,
    )  # fmt: skip


def _persistent_launch(
    gsel: torch.Tensor,  # int32[NB] on the card, checked by the caller
    gb: int,
    wni: torch.Tensor,  # int32[K, G] on the card, checked by the caller
    wen: torch.Tensor,  # int32[K, G] 0/1 on the card, checked by the caller
    crnd, quorum, alive, st_rnd, st_vrnd, st_val, ldel, linst, lval, values,
    limit: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """Launch K5 on checked inputs (CUDA-graph capturable: no host copy).
    ``persistent_wirepath_round`` is the checked wrapper."""
    global persistent_launches
    g, a, n = st_rnd.shape
    k, c, b, v = values.shape
    dev = values.device
    fresh = torch.empty((k, c, b), dtype=torch.bool, device=dev)
    win = torch.empty((k, c, b), dtype=torch.int32, device=dev)
    value = torch.empty((k, c, b, v), dtype=torch.int32, device=dev)
    fn = _kernel("persistent_wirepath_round")
    geo = wave_geometry(v, b, c, k, n, _aligned(st_val, lval, values, value))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            gsel.data_ptr(), gsel.numel(), gb,
            wni.data_ptr(), wen.data_ptr(), crnd.data_ptr(), limit.data_ptr(),
            alive.data_ptr(), int(quorum), k, g, a, n, v, b,
            st_rnd.data_ptr(), st_vrnd.data_ptr(), st_val.data_ptr(),
            ldel.data_ptr(), linst.data_ptr(), lval.data_ptr(),
            values.data_ptr(), fresh.data_ptr(), win.data_ptr(), value.data_ptr(),
            geo.variant == "vector", geo.team, geo.block, stream,
        )  # fmt: skip
    _launched(geo, rc, "persistent_wirepath_round launch")
    persistent_launches += 1
    return st_rnd, st_vrnd, st_val, ldel, linst, lval, fresh, win, value


def acceptor_vote_all_window(
    st_rnd: torch.Tensor,  # int32[A, N]  stacked acceptor rings, in place
    st_vrnd: torch.Tensor,  # int32[A, N]
    st_val: torch.Tensor,  # int32[A, N, V]
    alive: torch.Tensor,  # bool[A]
    msgtype: torch.Tensor,  # int32[B]
    inst: torch.Tensor,  # int32[B]  the lanes' instances, distinct slots
    msg_rnd: torch.Tensor,  # int32[B]
    msg_val: torch.Tensor,  # int32[B, V]
) -> tuple[torch.Tensor, ...]:
    """The staged vote of the whole acceptor array on the card, a team of
    threads per (acceptor, lane).  ``msg_val`` may be a view into a larger
    burst (contiguous rows, any start): the variant follows its alignment.
    Returns ``(st_rnd, st_vrnd, st_val, vote_type, vote_inst, vote_rnd,
    vote_vrnd, vote_swid, vote_value)``: the stacked rings are the inputs,
    updated in place; the votes are ``(A, B)`` and ``(A, B, V)``."""
    global vote_all_launches
    what = "acceptor_vote_all_window"
    a, n = st_rnd.shape
    votes = vote_io(what, (a,), n, msgtype, inst, msg_rnd, msg_val)
    dev, (b, v) = msg_val.device, msg_val.shape
    _build.require(what, "alive", alive, torch.bool, (a,), dev)
    _build.require(what, "st_rnd", st_rnd, torch.int32, (a, n), dev)
    _build.require(what, "st_vrnd", st_vrnd, torch.int32, (a, n), dev)
    _build.require(what, "st_val", st_val, torch.int32, (a, n, v), dev)
    fn = _kernel("acceptor_vote_all")
    geo = _lanes(v, b, a, msg_val, st_val, votes[5])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            alive.data_ptr(), a, n, v, b,
            msgtype.data_ptr(), inst.data_ptr(), msg_rnd.data_ptr(), msg_val.data_ptr(),
            st_rnd.data_ptr(), st_vrnd.data_ptr(), st_val.data_ptr(),
            *(t.data_ptr() for t in votes),
            geo.variant == "vector", geo.team, geo.block, stream,
        )  # fmt: skip
    _launched(geo, rc, f"{what} launch")
    vote_all_launches += 1
    return (st_rnd, st_vrnd, st_val, *votes)
