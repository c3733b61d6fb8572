"""Broadphase pair pruning for a batch of scenarios, counterpart of
`eggshell_tpu.ops.broadphase`.

- `box_aabbs`: world AABBs of oriented boxes, extent |R| h + margin.
- `pair_overlap_mask`: the AABB overlap of each candidate pair, from the
  (n, n) overlap matrix.
- `select_pairs`: the overlapping pairs compacted into `capacity` lanes in
  their original order; idle lanes point at pair (0, 0) with their gate
  off.  The JAX package takes the top `capacity` of a rank score; a cumsum
  and a scatter give the same lanes in a few operations.
- `sap_select_pairs`: the same lanes from a sort-and-sweep strip: bodies
  sorted by AABB min-x, each tested against the `window` bodies after it.
  Pairs further apart than `window` in that order are dropped silently, as
  in the JAX package; the pair rank is int64 here (the JAX package's
  int32 rank overflows above about 46k bodies).
- `select_scene_pairs`: the per-scene dispatch on cfg.broadphase_kind.
- `sweep_and_prune_pairs`: every overlapping i < j pair in row-major
  order, compacted into `capacity` lanes without a host read (a cumsum and
  a scatter where the JAX package calls `jnp.nonzero(size=...)`).

Every function takes a leading scenario axis B and reads nothing back to
the host, so a CUDA graph captures it; `select_scene_pairs` reads the
scene's pair list once a list to learn whether it is the canonical one.
"""

from __future__ import annotations

import weakref

import torch

from eggshell_tpu_torch.ops import quaternion as quat


def box_aabbs(p, q, half_extents, margin: float = 0.0):
    """(lo, hi) world AABBs, (B, n, 3) each: p (B, n, 3), q (B, n, 4),
    half_extents (n, 3); the extent along world axis i is
    sum_j |R_ij| h_j + margin."""
    R = quat.quat_to_mat(q)
    ext = torch.einsum("...nij,nj->...ni", R.abs(), half_extents) + margin
    return p - ext, p + ext


def aabb_overlap(lo1, hi1, lo2, hi2):
    """Elementwise AABB overlap (broadcasts over the leading dims)."""
    return torch.all((lo1 <= hi2) & (lo2 <= hi1), dim=-1)


def _overlap_matrix(lo, hi):
    """(B, n, n) AABB overlap of every body with every body."""
    return aabb_overlap(lo[:, :, None, :], hi[:, :, None, :], lo[:, None, :, :], hi[:, None, :, :])


def pair_overlap_mask(p, q, half_extents, pair_i, pair_j, margin: float = 0.0):
    """(B, P) bool: the candidate pairs (pair_i, pair_j (P,)) whose AABBs
    overlap."""
    lo, hi = box_aabbs(p, q, half_extents, margin)
    return _overlap_matrix(lo, hi)[:, pair_i, pair_j]


def running_count(mask):
    """(B, P) int64: the True entries of each row of mask (B, P) up to and
    including each position.  One scan over the rows flattened (integer,
    so exact in any order): torch scans along the rows of a few long rows
    on few threads."""
    m = mask.to(torch.int64)
    flat = torch.cumsum(m.reshape(-1), 0).reshape(m.shape)
    return flat - (flat[:, :1] - m[:, :1])


def _first_lanes(mask, capacity: int):
    """(index, active), (B, capacity) each: the positions of the first
    `capacity` True entries of each row of mask (B, P), in order; lanes
    past them index 0, inactive."""
    B, P = mask.shape
    dev = mask.device
    count = running_count(mask)
    slot = torch.where(mask & (count <= capacity), count - 1,
                       torch.full_like(count, capacity))                # capacity = discard
    index = torch.zeros((B, capacity + 1), dtype=torch.int64, device=dev)
    index = index.scatter(1, slot, torch.arange(P, device=dev).expand(B, P))[:, :capacity]
    return index, torch.arange(capacity, device=dev) < count[:, -1:]


def _top_lanes(score, bi, bj, capacity: int):
    """The `capacity` highest positive scores in descending order: their
    (bi, bj) and gate; lanes without one point at (0, 0), gate off."""
    v, order = torch.topk(score, capacity, dim=-1, sorted=True)
    active = v > 0
    zero = torch.zeros((), dtype=bi.dtype, device=bi.device)
    sel_i = torch.gather(bi.expand(score.shape), -1, order)
    sel_j = torch.gather(bj.expand(score.shape), -1, order)
    return torch.where(active, sel_i, zero), torch.where(active, sel_j, zero), active


def select_pairs(mask, pair_i, pair_j, capacity: int):
    """Compact the overlapping pairs (mask (B, P)) into `capacity` lanes,
    their original order kept.  Returns (sel_i, sel_j, active), (B,
    capacity) each."""
    index, active = _first_lanes(mask, capacity)
    zero = torch.zeros((), dtype=pair_i.dtype, device=pair_i.device)
    return (torch.where(active, pair_i[index], zero), torch.where(active, pair_j[index], zero),
            active)


def sap_select_pairs(p, q, half_extents, capacity: int, window: int, margin: float = 0.0,
                     num_pairs: int = None):
    """Sort-and-sweep pair selection: the lanes `select_pairs` gives on the
    canonical all-pairs list (i < j, row-major), wherever no overlapping
    pair lies more than `window` bodies apart in the min-x order.  Returns
    (pi, pj, active), (B, capacity) each."""
    lo, hi = box_aabbs(p, q, half_extents, margin)
    B, n = lo.shape[:2]
    dev = lo.device
    if num_pairs is None:
        num_pairs = n * (n - 1) // 2
    order = torch.argsort(lo[..., 0], dim=-1, stable=True)            # (B, n)
    lo_s = torch.gather(lo, 1, order[..., None].expand(B, n, 3))
    hi_s = torch.gather(hi, 1, order[..., None].expand(B, n, 3))
    k = torch.arange(n, device=dev)[:, None]
    d = torch.arange(1, window + 1, device=dev)[None]
    jdx = torch.clamp(k + d, max=n - 1)                                # (n, W)
    valid = (k + d) < n
    lo_j, hi_j = lo_s[:, jdx], hi_s[:, jdx]                            # (B, n, W, 3)
    # sorted by min-x: x overlaps iff lo_x[j] <= hi_x[k]; y and z in full
    ov = lo_j[..., 0] <= hi_s[:, :, None, 0]
    for ax in (1, 2):
        ov = ov & (lo_j[..., ax] <= hi_s[:, :, None, ax]) & (lo_s[:, :, None, ax] <= hi_j[..., ax])
    ov = ov & valid
    a = order[:, :, None].expand(B, n, window)
    b = order[:, jdx]
    bi = torch.minimum(a, b).reshape(B, -1)
    bj = torch.maximum(a, b).reshape(B, -1)
    # the pair's index in the canonical list, int64
    rank = bi * (2 * n - bi - 1) // 2 + (bj - bi - 1)
    score = torch.where(ov.reshape(B, -1), num_pairs - rank, torch.zeros_like(rank))
    if capacity > score.shape[-1]:       # capacity exceeds the strip
        pad = capacity - score.shape[-1]
        score, bi, bj = (torch.nn.functional.pad(x, (0, pad)) for x in (score, bi, bj))
    return _top_lanes(score, bi, bj, capacity)


# id(pair_i) -> (a weak reference to pair_i, its canonicity)
_canonical = {}


def _canonical_pairs(spec) -> bool:
    """Whether spec's pair list is the all-pairs i < j enumeration in
    row-major order (`make_scene`'s default), the condition for the
    sort-and-sweep's rank.  Read from the host once for each pair list."""
    pi = spec.pair_i
    hit = _canonical.get(id(pi))
    if hit is not None and hit[0]() is pi:
        return hit[1]
    n, P = spec.num_bodies, spec.num_pairs
    ok = P == n * (n - 1) // 2
    if ok:
        ci, cj = torch.triu_indices(n, n, 1)
        ok = bool(torch.equal(pi.cpu(), ci) and torch.equal(spec.pair_j.cpu(), cj))
    for key in [key for key, (ref, _) in _canonical.items() if ref() is None]:
        del _canonical[key]
    _canonical[id(pi)] = (weakref.ref(pi), ok)
    return ok


def select_scene_pairs(spec, states, cfg):
    """The broadphase of every scenario: AABB-prune the scene's candidate
    pairs and compact them into cfg.pair_capacity lanes.  "mask" (the
    overlap matrix, then `select_pairs`) or "sap" (`sap_select_pairs`,
    which takes the canonical all-pairs list only; another list takes the
    mask).  Returns (pi, pj, gate), (B, pair_capacity) each."""
    if cfg.broadphase_kind == "sap" and _canonical_pairs(spec):
        return sap_select_pairs(states.p, states.q, spec.half_extents, cfg.pair_capacity,
                                cfg.sap_window, cfg.broadphase_margin, spec.num_pairs)
    mask = pair_overlap_mask(states.p, states.q, spec.half_extents, spec.pair_i, spec.pair_j,
                             cfg.broadphase_margin)
    return select_pairs(mask, spec.pair_i, spec.pair_j, cfg.pair_capacity)


def sweep_and_prune_pairs(lo, hi, capacity: int):
    """Every overlapping pair i < j of the AABBs lo / hi (B, n, 3), in
    row-major order, compacted into `capacity` lanes; lanes past the
    overlapping pairs are (0, 0).  Returns (pi, pj, active), (B, capacity)
    each."""
    B, n = lo.shape[:2]
    i = torch.arange(n, device=lo.device)
    mask = (_overlap_matrix(lo, hi) & (i[:, None] < i[None, :])).reshape(B, n * n)
    flat, active = _first_lanes(mask, capacity)
    return flat // n, flat % n, active
