"""Vector-quantization bottleneck, plain PyTorch version, and its gradient.

Counterpart of ``kindergarten_vq_vae_tpu/ops/vq.py`` ``vector_quantize``
(l.38) and ``ops/vq_pallas.py`` ``fused_vector_quantize`` (l.187): centered
distances (vq.py l.55-62), first-minimum argmin, ``z_q`` as the chosen code
rows, the per-code ``counts`` / ``sum_z`` statistics, the sum ``diff`` of
``(z_q - z)^2``, and from them ``loss = (diff + beta * diff) / numel``, the
straight-through value ``z + (z_q - z)`` and the codebook perplexity.

The gradient is :class:`VQCore`, the JAX package's custom VJP
(``vq_pallas.py:149-184``): the loss's two terms are the same value with two
gradient paths, ``d1 ~ sum((sg[z_q] - z)^2)`` and ``d2 ~ sum((z_q - sg[z])^2)``,
so ``dz = g_zq + 2 g_d1 (z - z_q)`` and ``dE = segment_sum(2 g_d2 (z_q - z))``.
The raw forward is :func:`vq_raw` here and the CUDA kernel in
:mod:`kindergarten_vq_vae_torch.ops.vq_kernel`; the codebook gradient is
:func:`codebook_grad` (``csrc/vq_bwd.cu`` on the card, summed in a fixed
order; ``index_add_`` on the CPU); everything else is shared.

Beside them, the plain versions of what the card's general path does in
other arithmetic: :func:`vq_screen_reference` (the tensor-core screen, its
TF32 split emulated, and the recheck of the codes it keeps) and
:func:`grouped_sum_reference` (the per-code sums over the rows grouped by
code, in the kernels' fixed order, to the bit).

The codebook's training extras of ``ops/vq.py`` follow: the EMA codebook
update (l.99-128), the k-means codebook initialisation (l.131-168) and
dead-code revival (l.171-198), whose random draws come from a
:class:`torch.Generator` and whose arithmetic given the draws is
:func:`kmeans_codebook_init_with` and :func:`dead_code_reset_with`.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from kindergarten_vq_vae_torch import _build
from kindergarten_vq_vae_torch.parallel.mesh import active_mesh, dp_sum
from kindergarten_vq_vae_torch.utils.metrics import perplexity_from_counts

_VP, _I = ctypes.c_void_p, ctypes.c_int


class VQOutput(NamedTuple):
    loss: torch.Tensor          # scalar commitment + codebook loss
    z_q: torch.Tensor           # (B, S, D) straight-through quantized latents
    perplexity: torch.Tensor    # scalar codebook usage perplexity
    one_hot: torch.Tensor       # (B*S, n_e) hard assignments
    indices: torch.Tensor       # (B, S, 1) int64 code indices
    counts: torch.Tensor        # (n_e,) per-code assignment counts
    sum_z: torch.Tensor         # (n_e, D) per-code sum of z


def vq_raw(z_flat: torch.Tensor, codebook: torch.Tensor):
    """Plain raw forward of (rows, D) f32 ``z_flat``: ``(z_q, indices (int64),
    counts, sum_z, diff)``.

    Distances use values centered on the codebook mean: the raw expansion
    ``|z|^2 + |e|^2 - 2 z.e`` loses its resolution when the codes sit close
    together far from the origin (see the JAX oracle's docstring)."""
    n_e = codebook.shape[0]
    center = codebook.mean(0)
    zc = z_flat - center
    ec = codebook - center
    dist = (zc * zc).sum(1, keepdim=True) + (ec * ec).sum(1) - 2.0 * (zc @ ec.T)
    indices = dist.argmin(1)  # first minimum on ties
    one_hot = F.one_hot(indices, n_e).to(z_flat.dtype)
    z_q = codebook[indices]  # exactly one_hot @ codebook
    return z_q, indices, one_hot.sum(0), one_hot.T @ z_flat, ((z_q - z_flat) ** 2).sum()


RawFn = Callable[[torch.Tensor, torch.Tensor], tuple]


def _core(z_flat, codebook, raw_fn: RawFn):
    """``(z_q_ste, diff, indices, counts, sum_z, group)`` from a raw forward.
    A raw forward whose ``returns_ste`` attribute is true (the CUDA
    kernel's) returns the straight-through value ``z + (z_q - z)`` itself;
    for the others it is computed here. A raw forward may return a sixth
    element, the kernel's grouping of the rows by code (int32; None where it
    left none), which the codebook gradient then takes as it is; ``group``
    is None for the others."""
    zq, idx, counts, sumz, diff, *group = raw_fn(z_flat, codebook)
    if not getattr(raw_fn, "returns_ste", False):
        zq = z_flat + (zq - z_flat)
    return zq, diff, idx, counts, sumz, group[0] if group else None


class VQCore(torch.autograd.Function):
    """``(z_q_ste, diff1, diff2, indices, counts, sum_z)`` of ``z_flat``
    against ``codebook`` with the custom VJP of ``_fused_vq_core``; the raw
    forward's grouping of the rows by code waits on ``ctx`` for the
    backward's codebook gradient."""

    @staticmethod
    def forward(ctx, z_flat, codebook, raw_fn: RawFn):
        z_q, diff, idx, counts, sumz, ctx.group = _core(z_flat, codebook, raw_fn)
        ctx.save_for_backward(z_flat, codebook, idx)
        ctx.mark_non_differentiable(idx, counts, sumz)
        return z_q, diff, diff.clone(), idx, counts, sumz

    @staticmethod
    def backward(ctx, g_zq, g_d1, g_d2, _g_idx, _g_counts, _g_sumz):
        z_flat, codebook, idx = ctx.saved_tensors
        dz = dE = None
        if ctx.needs_input_grad[0]:
            dz = torch.zeros_like(z_flat) if g_zq is None else g_zq
            if g_d1 is not None:
                dz = dz + g_d1 * 2.0 * (z_flat - codebook[idx])
        if ctx.needs_input_grad[1]:
            dE = (torch.zeros_like(codebook) if g_d2 is None
                  else codebook_grad(z_flat, idx, codebook, g_d2, ctx.group))
        return dz, dE, None


def codebook_grad_reference(z_flat: torch.Tensor, idx: torch.Tensor, codebook: torch.Tensor,
                            g_d2: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`codebook_grad`: ``index_add_`` of the terms,
    in row order on the CPU (with atomics in any order on the card)."""
    return torch.zeros_like(codebook).index_add_(0, idx, g_d2 * 2.0 * (codebook[idx] - z_flat))


def codebook_grad(z_flat: torch.Tensor, idx: torch.Tensor, codebook: torch.Tensor,
                  g_d2: torch.Tensor, group: torch.Tensor | None = None) -> torch.Tensor:
    """The codebook's gradient ``dE[k] = sum_{i: idx[i] = k} 2 g_d2 (E[k] -
    z[i])`` of (rows, D) f32 ``z_flat``, (rows,) int64 ``idx`` and (n_e, D)
    f32 ``codebook``; ``g_d2`` a one-element f32 tensor (read on the device:
    no host sync). JAX's ``jax.ops.segment_sum`` in ``_fused_vq_core_bwd``
    (``vq_pallas.py:173-181``).

    CPU tensors take :func:`codebook_grad_reference`. CUDA tensors launch
    ``csrc/vq_bwd.cu``, which sums each code's terms in a fixed order (the
    same bits in every launch; :func:`grouped_sum_reference` repeats it)
    over any D and codebook (past ~113 codes at D 768 over the rows grouped
    by code), or raise; each launch adds one to ``codebook_grad.launches``.
    ``group``: the grouping of these rows that the VQ forward's general path
    returned (the raw forward's sixth element, on ``VQCore``'s ``ctx``),
    which the grouped sums then take as it is."""
    if z_flat.device.type == "cpu":
        return codebook_grad_reference(z_flat, idx, codebook, g_d2)
    if z_flat.device.type != "cuda":
        raise ValueError(f"codebook_grad runs on CPU or CUDA tensors, got {z_flat.device}")
    m, d = z_flat.shape
    n_e = codebook.shape[0]
    dev = z_flat.device
    g = g_d2.reshape(1)
    for name, t, shape, dtype in (("z_flat", z_flat, (m, d), torch.float32),
                                  ("idx", idx, (m,), torch.int64),
                                  ("codebook", codebook, (n_e, d), torch.float32),
                                  ("g_d2", g, (1,), torch.float32)):
        _build.check_tensor(name, t, shape, dtype, dev)
    if m == 0:
        return torch.zeros_like(codebook)
    plan = codebook_grad_plan(z_flat, codebook)
    if plan is None:
        raise ValueError(f"the codebook-gradient kernel takes at least one column and code; "
                         f"got D={d}, n_e={n_e}")
    scratch, width = plan
    ws = torch.empty((scratch,), dtype=torch.float32, device=dev)
    out = torch.empty((width,), dtype=torch.float32, device=dev)
    if group is not None:
        _build.check_tensor("group", group, group.shape, torch.int32, dev)
    _build.launch("kvq_vq_codebook_grad", [_VP] * 7 + [_I] * 3, z_flat.data_ptr(),
                  idx.data_ptr(), codebook.data_ptr(), g.data_ptr(), ws.data_ptr(),
                  out.data_ptr(), None if group is None else group.data_ptr(), m, d, n_e,
                  device=dev)
    codebook_grad.launches += 1
    return out[:n_e * d].view(n_e, d)


codebook_grad.launches = 0


def codebook_grad_plan(z_flat: torch.Tensor, codebook: torch.Tensor) -> tuple[int, int] | None:
    """The codebook-gradient kernel's plan for CUDA tensors ``z_flat`` (m, D)
    and ``codebook`` (n_e, D), from ``kvq_vq_codebook_grad_plan``: (the
    floats of its scratch, the floats of the output), or None for a shape it
    refuses. The one-pass kernel's partials hold at most 2^22 floats of n_e
    x D sums, or one partial where that is larger; the grouped sums' scratch
    is the grouping, a few ints a row and a code (``csrc/vq_bwd.cu``)."""
    fn = _build.lib().kvq_vq_codebook_grad_plan
    fn.argtypes = [_I, _I, _I, _VP, _VP, ctypes.POINTER(_I)]
    fn.restype = _I
    plan = (_I * 2)()
    (m, d), n_e = z_flat.shape, codebook.shape[0]
    if fn(m, d, n_e, z_flat.data_ptr(), codebook.data_ptr(), plan) != 0:
        return None
    return plan[0], plan[1]


def screen_kappa(d: int) -> float:
    """The screen's kappa at width ``d``: twice the bound on |cross' - cross|
    over ||z - c|| ||e_k - c||, cross' the 3xTF32 product and cross the
    in-order f32 sum (``csrc/vq_fwd.cu``'s module comment derives it)."""
    u = 2.0**-24
    return 2.0 * (2.0**-20 + (1 + 2.0**-9) * (2.0**-16 + -(-d // 32) * u) + d * u) * (1 + 2.0**-20)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(big, small)`` f32 with x = big + small + r: big the TF32 rounding of
    x (10 mantissa bits, half away from zero: ``cvt.rna``), small that of
    x - big, |r| <= 2^-22 |x|."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
        return (mag | (bits & -0x80000000)).view(torch.float32)

    big = rna(x)
    return big, rna(x - big)


def vq_screen_reference(z_flat: torch.Tensor, codebook: torch.Tensor,
                        kappa: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the card's screen and recheck (``csrc/vq_fwd.cu``'s
    general path), f32 (rows, D) ``z_flat`` against (n_e, D) ``codebook``:
    ``(kept, indices)``. The products cross' = (z - c) . (e_k - c) come from
    the TF32 split (:func:`tf32_split`, small * small dropped, the rest
    summed in f64 and rounded to f32); t'_k = q_k - 2 cross'_k with q_k =
    ||e_k - c||^2, the margin M_k = 2 kappa ||z - c|| ||e_k - c|| + 2^-21
    (||z - c|| + ||e_k - c||)^2, U = min_k (t'_k + M_k), and ``kept`` (rows,
    n_e) the codes with t'_k - M_k <= U. ``indices``: the first minimum of
    the plain distances (:func:`vq_raw`'s arithmetic) over the kept codes."""
    center = codebook.mean(0)
    zc, ec = z_flat - center, codebook - center
    q = (ec * ec).sum(1)
    s = (zc * zc).sum(1, keepdim=True)
    zb, zs = (t.double() for t in tf32_split(zc))
    eb, es = (t.double() for t in tf32_split(ec))
    cross = (zs @ eb.T + zb @ es.T + zb @ eb.T).float()
    t = q - 2.0 * cross
    nx, ny = s.double().sqrt(), q.double().sqrt()
    k = screen_kappa(z_flat.shape[1]) if kappa is None else kappa
    margin = 2.0 * k * nx * ny + 2.0**-21 * (nx + ny) ** 2
    upper = t.double() + margin
    kept = t.double() - margin <= upper.min(1, keepdim=True).values
    dist = s + q - 2.0 * (zc @ ec.T)
    return kept, dist.masked_fill(~kept, float("inf")).argmin(1)


def grouped_order(rows: int, d: int, n_e: int, vec: bool = True) -> tuple[int, int]:
    """``(rows_per_block, slots)`` of the card's per-code sums at (rows, D) x
    n_e (``csrc/vq_bwd.cu`` ``row_plan`` and ``order_warps``): as many row
    blocks, at most 128, as 2^22 floats hold n_e x D sums, each a multiple of
    16 rows; 4 slots, or 2 or 1 where the one-pass kernel's four per-warp
    slabs of 128 columns (32 off the 16-byte path, ``vec``) do not fit in
    232,448 bytes of shared memory but fewer do."""
    fit = (1 << 22) // (n_e * d)
    per = -(-rows // max(1, min(fit, 128)))
    cw = min(d, 128 if vec else 32)
    slots = next((w for w in (4, 2, 1) if (w * cw + 1) * n_e * 4 <= 232448), 4)
    return -(-per // 16) * 16, slots


def grouped_sum_reference(terms: torch.Tensor, idx: torch.Tensor, n_e: int,
                          rows_per_block: int, slots: int) -> torch.Tensor:
    """Plain version of the card's per-code sums (``csrc/vq_bwd.cu``), to the
    bit: out[k] sums the (rows, D) f32 ``terms`` of the rows with idx = k,
    in the kernels' fixed order. The rows are grouped by a stable sort on
    (code, row block, slot); in each row block of ``rows_per_block`` rows, slot w (w <
    ``slots``) adds its rows row0 + w + j slots in order from 0; a block's
    partial is its slots in order; strip s adds the partials of row blocks
    s, s + 8, ... in order from 0; out is strip 0 + ... + strip 7. Every add
    is one f32 add of whole rows (each term as the caller rounded it); a code
    no row picks is exactly 0."""
    rows, d = terms.shape
    n_blocks = -(-rows // rows_per_block)
    every = torch.arange(rows, device=idx.device)
    # the rows grouped by (code, block, slot), each group's rows ascending,
    # and a row's rank in its group
    key = (idx * n_blocks + every // rows_per_block) * slots + every % slots
    row = torch.sort(key, stable=True).indices
    code, block, slot, key = idx[row], row // rows_per_block, row % slots, key[row]
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    rank = every - torch.cummax(torch.where(first, every, 0), 0).values
    acc = torch.zeros(n_e, n_blocks, slots, d, dtype=terms.dtype, device=terms.device)
    for r in range(int(rank.max()) + 1 if rows else 0):
        at = rank == r
        acc[code[at], block[at], slot[at]] += terms[row[at]]
    strips = torch.zeros(8, n_e, d, dtype=terms.dtype, device=terms.device)
    for b in range(n_blocks):
        part = acc[:, b, 0].clone()
        for w in range(1, slots):
            part += acc[:, b, w]
        strips[b % 8] += part
    out = strips[0].clone()
    for w in range(1, 8):
        out += strips[w]
    return out


def assemble(z: torch.Tensor, codebook: torch.Tensor, beta: float, raw_fn: RawFn) -> VQOutput:
    """The bottleneck's outputs from a raw forward (``fused_vector_quantize``
    l.203-228). Under a mesh with dp ranks
    (:func:`~kindergarten_vq_vae_torch.parallel.mesh.active_mesh`), ``z`` is
    this rank's rows (``fused_vector_quantize_sharded`` l.231-290): ``d1``,
    ``d2``, the counts and ``sum_z`` are summed over dp in one all-reduce,
    the loss divides by the global element count and the perplexity comes
    from the global counts; the loss's gradient is the local share's
    (:func:`~kindergarten_vq_vae_torch.parallel.mesh.dp_sum`), and ``z_q``,
    ``one_hot`` and ``indices`` stay local."""
    batch, seq_len, d = z.shape
    n_e = codebook.shape[0]
    z_flat = z.reshape(-1, d)
    if torch.is_grad_enabled() and (z.requires_grad or codebook.requires_grad):
        z_q, d1, d2, idx, counts, sumz = VQCore.apply(z_flat, codebook, raw_fn)
    else:  # serving: no autograd bookkeeping
        z_q, d1, idx, counts, sumz, _ = _core(z_flat, codebook, raw_fn)
        d2 = d1
    numel, rows = z_flat.numel(), z_flat.shape[0]
    mesh = active_mesh()
    if mesh is not None and mesh.dp_group is not None:
        d1, d2, counts, sumz = dp_sum(d1, d2, counts, sumz)
        numel, rows = numel * mesh.dp_size, rows * mesh.dp_size
    return VQOutput(
        loss=(d1 + beta * d2) / numel,
        z_q=z_q.reshape(z.shape),
        perplexity=perplexity_from_counts(counts, rows),
        one_hot=F.one_hot(idx, n_e).to(z.dtype),
        indices=idx.reshape(batch, seq_len, 1),
        counts=counts,
        sum_z=sumz,
    )


def vector_quantize(z: torch.Tensor, codebook: torch.Tensor, beta: float) -> VQOutput:
    """Quantize ``z`` (B, S, D) against ``codebook`` (n_e, D), both f32, in
    plain PyTorch on any device (the kernel's comparison baseline)."""
    return assemble(z, codebook, beta, vq_raw)


class EMAState(NamedTuple):
    counts: torch.Tensor  # (n_e,) EMA of per-code assignment counts
    means: torch.Tensor   # (n_e, D) EMA of per-code sums of z


def init_ema_state(codebook: torch.Tensor) -> EMAState:
    """``ops/vq.py:104-106``: unit counts, means at the codebook."""
    return EMAState(torch.ones(codebook.shape[0], dtype=codebook.dtype, device=codebook.device),
                    codebook.detach().clone())


def ema_codebook_update(codebook: torch.Tensor, state: EMAState, counts: torch.Tensor,
                        sum_z: torch.Tensor, decay: float = 0.99, eps: float = 1e-5):
    """``(new_codebook, new_state)``: the EMA codebook update of
    ``ops/vq.py:109-128`` (VQ-VAE appendix A.1) from one batch's per-code
    ``counts`` and ``sum_z``, with Laplace smoothing of the counts."""
    new_counts = decay * state.counts + (1.0 - decay) * counts
    new_means = decay * state.means + (1.0 - decay) * sum_z
    n = new_counts.sum()
    n_e = codebook.shape[0]
    smoothed = (new_counts + eps) / (n + n_e * eps) * n
    return new_means / smoothed[:, None], EMAState(new_counts, new_means)


def lloyd_step(z_flat: torch.Tensor, zc: torch.Tensor, gmean: torch.Tensor,
               cent: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration of ``kmeans_codebook_init``'s body (``ops/vq.py``
    l.153-166): ``(new centroids, assignments)``. Rows are assigned on the
    data centred by the global mean ``gmean`` (``zc = z_flat - gmean``) to
    the first nearest centroid; a centroid becomes the mean of its rows, by
    one-hot products in ``z_flat``'s dtype, and an empty cluster keeps its
    centroid."""
    n_e = cent.shape[0]
    cc = cent - gmean
    dist = (zc * zc).sum(1, keepdim=True) + (cc * cc).sum(1) - (2.0 * zc) @ cc.T
    assign = dist.argmin(1)  # first minimum on ties
    oh = F.one_hot(assign, n_e).to(z_flat.dtype)
    counts = oh.sum(0)
    sums = oh.T @ z_flat
    new_cent = sums / torch.clamp_min(counts[:, None], 1.0)
    return torch.where(counts[:, None] > 0, new_cent, cent), assign


def kmeans_codebook_init_with(z_flat: torch.Tensor, init_idx: torch.Tensor,
                              n_iters: int = 25) -> torch.Tensor:
    """K-means codebook of the (m, D) rows ``z_flat`` from the initial rows
    ``init_idx`` (n_e distinct indices): ``n_iters`` Lloyd iterations
    (:func:`lloyd_step`), everything in ``z_flat``'s dtype. The centring
    matters: a trained encoder puts its rows on a tight shell far from the
    origin, where the raw ``|z|^2 + |c|^2 - 2 z.c`` expansion cannot tell the
    centroids apart (see ``vq_raw``)."""
    cent = z_flat[init_idx.to(z_flat.device)]
    gmean = z_flat.mean(0, keepdim=True)
    zc = z_flat - gmean
    for _ in range(n_iters):
        cent, _ = lloyd_step(z_flat, zc, gmean, cent)
    return cent


def kmeans_init_indices(m: int, n_e: int, generator: torch.Generator) -> torch.Tensor:
    """``n_e`` distinct row indices of ``m``, the first of a random
    permutation drawn from ``generator``. JAX draws them with
    ``jax.random.choice(key, m, (n_e,), replace=False)``, which torch cannot
    reproduce (a recorded divergence); a CPU generator draws the same rows
    whatever device the rows live on."""
    return torch.randperm(m, generator=generator, device=generator.device)[:n_e]


def kmeans_codebook_init(z_flat: torch.Tensor, n_e: int, generator: torch.Generator,
                         n_iters: int = 25) -> torch.Tensor:
    """K-means codebook initialisation over encoder outputs (the
    reference's offline ``scipy.cluster.vq.kmeans2(..., minit='points')``):
    distinct random rows, then :func:`kmeans_codebook_init_with`."""
    return kmeans_codebook_init_with(z_flat, kmeans_init_indices(z_flat.shape[0], n_e, generator),
                                     n_iters)


def dead_code_reset_with(codebook, dead_steps, counts, z_rows, pick, noise, threshold: int = 100,
                         noise_scale: float = 1e-3):
    """The arithmetic of ``ops/vq.py:171-198`` given its random draws:
    ``pick`` (n_e,) row indices into ``z_rows`` and ``noise`` (n_e, D)
    standard normals. ``dead_steps`` counts consecutive steps without an
    assignment; a code past ``threshold`` is re-seeded to ``z_rows[pick] +
    noise_scale * noise``. Returns ``(new_codebook, new_dead_steps)``."""
    dead_steps = torch.where(counts > 0, torch.zeros_like(dead_steps), dead_steps + 1)
    expired = dead_steps >= threshold
    replacements = z_rows.float()[pick] + noise_scale * noise
    new_codebook = torch.where(expired[:, None], replacements.to(codebook.dtype), codebook)
    return new_codebook, torch.where(expired, torch.zeros_like(dead_steps), dead_steps)


def dead_code_reset(codebook, dead_steps, counts, z_rows, generator: torch.Generator,
                    threshold: int = 100, noise_scale: float = 1e-3):
    """Dead-code revival with ``pick`` and ``noise`` drawn from ``generator``
    (on the codebook's device)."""
    n_e = codebook.shape[0]
    pick = torch.randint(0, z_rows.shape[0], (n_e,), generator=generator, device=codebook.device)
    noise = torch.randn(codebook.shape, generator=generator, device=codebook.device,
                        dtype=codebook.dtype)
    return dead_code_reset_with(codebook, dead_steps, counts, z_rows, pick, noise, threshold,
                                noise_scale)
