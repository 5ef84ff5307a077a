"""One post-LN BertLayer, forward and backward: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``kindergarten_vq_vae_tpu/ops/layer_pallas.py``
(``fused_bert_layer`` l.1129, ``_layer_fwd_core`` l.374, ``_layer_bwd_kernel``
l.552, ``_attn_bwd_tile`` l.304). The forward kernel is ``csrc/layer_fwd.cu``,
the backward ``csrc/layer_bwd.cu``, every projection of both goes
through the layer GEMM of ``ops/gemm.py`` (``csrc/gemm_sm90.cuh``), and
their LayerNorms and bias column sums through ``csrc/layernorm.cu``
(:func:`residual_layernorm`, :func:`layernorm_backward`,
:func:`column_sums`, each beside its plain version);
:func:`layer_forward_reference`,
:func:`layer_backward_reference` and :func:`attention_backward_reference`
are the same functions in plain PyTorch, at the same rounding points:

- matmul operands in the compute dtype, products accumulated in f32;
  biases and LayerNorm parameters f32;
- ``qkv``, ``qc``, ``kvc``, ``ctx``, ``x1``, ``x2``, ``u`` and the GELU output
  rounded to the compute dtype; residual sums in f32;
- attention per sentence with a finite ``NEG_INF`` key / causal bias, softmax
  as ``e / z`` in f32, the dropout keep mask applied after it, probabilities
  rounded before ``p @ v``;
- hidden dropout on the projection outputs before each residual add;
- LayerNorm with flax's fast variance ``max(E[r^2] - mu^2, 0)``;
- exact GELU as ``0.5 u (1 + tanh(z p(z^2)))``, the ``_ERF_P`` polynomial,
  and its gradient as the derivative of that polynomial form.

Weights follow :data:`ENC_WEIGHTS` / :data:`DEC_WEIGHTS`, in the JAX
package's ``(in, out)`` layout. :func:`fused_bert_layer` takes dropout
(``attn_rate`` / ``hid_rate`` in the geometry, with a seed) and gradients:
under autograd it runs :class:`FusedBertLayer`, whose forward keeps the
residuals of the JAX package's ``"full"`` layout (``_res_layout`` l.462) plus
the GELU output, and whose backward is the backward kernel. It refuses a
dropout rate outside ``[0, 1)``, dropout without a seed, and a second
derivative (the backward is not itself differentiable).

Divergence from the TPU kernel: the TPU accumulated each weight gradient
across 32-sentence tiles in bf16 (``_acc`` l.529); here the weight-gradient
GEMMs sum over all rows in f32 and round once to the compute dtype, which is
where the weight cast's VJP rounds.

The compute dtype is bf16 or f32 (JAX's parity dtype, in which the TPU
kernels run too). On CUDA each kernel has an f32 instance: the layer GEMM's
3xTF32 ``csrc/gemm_f32.cu``, the 3xTF32 ``mma.sync`` attention of
``csrc/attention_f32.cuh`` and the f32 rows of ``csrc/layernorm.cu``; every
wrapper's ``f32_launches`` counts the f32 share of its ``launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from kindergarten_vq_vae_torch import _build
from kindergarten_vq_vae_torch.ops.dropout import (
    OP_ATTN_OUT,
    OP_CROSS_OUT,
    OP_MLP_OUT,
    attention_keep,
    cross_op,
    hidden_keep,
    keep_scale,
    keep_threshold,
    seed_u32,
)
from kindergarten_vq_vae_torch.ops.gemm import gelu, gelu_grad, gemm, gemm_plan, sm_count

NEG_INF = -1e9

ENC_WEIGHTS = ("wqkv", "bqkv", "wo", "bo", "g1", "be1",
               "w1", "b1", "w2", "b2", "g3", "be3")
DEC_WEIGHTS = ("wqkv", "bqkv", "wo", "bo", "g1", "be1",
               "wq", "bq", "wkv", "bkv", "wco", "bco", "g2", "be2",
               "w1", "b1", "w2", "b2", "g3", "be3")

# limits of the attention kernels of csrc/attention.cuh (ATT_MAX_S, ATT_MAX_HD:
# a warp's q / k tiles of at most two m16 blocks, head_dim in at most eight
# k16 steps; `attention_fits`)
MAX_SEQ = 32
MAX_HEAD_DIM = 128
# the widest row of the LayerNorm kernels of csrc/layernorm.cu (LN_MAX_WIDTH:
# a row in a warp's registers, at most four 16-byte chunks a lane)
MAX_LN_WIDTH = 1024


@dataclasses.dataclass(frozen=True)
class LayerGeom:
    """Static configuration of one layer call (sequence lengths come from the inputs)."""

    num_heads: int
    head_dim: int
    intermediate: int
    causal: bool          # causal self-attention (decoder)
    has_cross: bool       # cross-attention onto ``enc`` (decoder)
    eps: float
    gelu_exact: bool
    attn_rate: float = 0.0
    hid_rate: float = 0.0

    @property
    def hidden(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def dropout(self) -> bool:
        return self.attn_rate > 0.0 or self.hid_rate > 0.0

    def weight_shapes(self) -> dict[str, tuple[int, ...]]:
        """Shape of each weight the layer takes, by name."""
        H, F = self.hidden, self.intermediate
        shapes = {"wqkv": (H, 3 * H), "bqkv": (3 * H,), "wo": (H, H), "bo": (H,),
                  "g1": (H,), "be1": (H,), "w1": (H, F), "b1": (F,), "w2": (F, H),
                  "b2": (H,), "g3": (H,), "be3": (H,)}
        if self.has_cross:
            shapes.update({"wq": (H, H), "bq": (H,), "wkv": (H, 2 * H), "bkv": (2 * H,),
                           "wco": (H, H), "bco": (H,), "g2": (H,), "be2": (H,)})
        return shapes


def _names(geom: LayerGeom) -> tuple[str, ...]:
    return DEC_WEIGHTS if geom.has_cross else ENC_WEIGHTS


@functools.lru_cache(maxsize=64)
def _weight_specs(geom: LayerGeom) -> tuple:
    """(name, shape, matmul kernel?, LayerNorm parameter?) of each weight, in call order."""
    shapes = geom.weight_shapes()
    return tuple((n, torch.Size(shapes[n]), n.startswith("w"), n.startswith(("g", "be")))
                 for n in _names(geom))


def layer_gemms(geom: LayerGeom) -> tuple[int, int]:
    """Launches of the layer GEMM (``ops/gemm.py``) in one forward and one
    backward of the layer: 4 and 8, or with cross-attention 7 and 14."""
    return (7, 14) if geom.has_cross else (4, 8)


# residuals the forward keeps for the backward, by name, in this order
def residual_names(geom: LayerGeom) -> tuple[str, ...]:
    cross = ("qc", "kvc", "ctx2", "x2") if geom.has_cross else ()
    return ("qkv", "ctx", "x1") + cross + ("u", "m", "invs")


# ---------------------------------------------------------------- plain version


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(rows, K) @ (K, N) with f32 accumulation; operands keep their values."""
    return a.float() @ w.float()


def _mm_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T @ b over rows: (rows, K)^T @ (rows, N) -> f32 (K, N)."""
    return a.float().T @ b.float()


def _mm_nt(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w^T: (rows, N) @ (K, N)^T -> f32 (rows, K)."""
    return a.float() @ w.float().T


def _ln(r: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float):
    """Post-LN of f32 rows: (output, per-row rsqrt)."""
    mu = r.mean(-1, keepdim=True)
    var = torch.clamp((r * r).mean(-1, keepdim=True) - mu * mu, min=0.0)
    inv = torch.rsqrt(var + eps)
    return (r - mu) * inv * gamma + beta, inv[:, 0]


def _ln_bwd(gy, yhat, inv, gamma):
    """d/dr of the LayerNorm given the f32 upstream gy (``_ln_bwd`` l.175)."""
    dyhat = gy * gamma
    m1 = dyhat.mean(-1, keepdim=True)
    m2 = (dyhat * yhat).mean(-1, keepdim=True)
    return inv[:, None] * (dyhat - m1 - yhat * m2)


def _recover_yhat(v, gamma, beta):
    """The normalised value behind a stored LayerNorm output (``_ln_recover_yhat`` l.542)."""
    return torch.where(gamma == 0.0, 0.0, (v.float() - beta) / gamma)


def residual_layernorm_reference(x, a, gamma, beta, eps: float, keep=None):
    """Plain residual + post-LN of the layer forward (``_ln_fwd`` l.164):
    ``(out, inv)``, out = LN(float(x) + a * keep) in x's dtype with flax's
    fast variance, inv each row's rsqrt (f32). x (M, N); a (M, N) f32;
    keep (M, N) the hidden site's keep/scale mask, or None."""
    r = x.float() + (a if keep is None else a * keep)
    out, inv = _ln(r, gamma, beta, eps)
    return out.to(x.dtype), inv


def layernorm_backward_reference(gy, v, inv, gamma, beta, keep=None):
    """Plain LayerNorm backward from the stored output v and rsqrt inv
    (``_ln_recover_yhat`` l.542, ``_ln_bwd`` l.175), with the column sums
    ``_layer_backward_xla`` forms beside it (l.1047-1057): ``(dr, da,
    dgamma, dbeta, dbias)``, all f32: dr the gradient at the LayerNorm's
    input for the upstream gy, da = dr * keep (keep the hidden site's mask
    or None), and the sums over rows of gy * yhat, gy and da."""
    g = gy.float()
    yhat = _recover_yhat(v, gamma, beta)
    dr = _ln_bwd(g, yhat, inv, gamma)
    da = dr if keep is None else dr * keep
    return dr, da, (g * yhat).sum(0), g.sum(0), da.sum(0)


def column_sums_reference(src):
    """Plain f32 column sums of a (rows, N) matrix (a bias gradient)."""
    return src.float().sum(0)


def _heads(t: torch.Tensor, nh: int) -> torch.Tensor:
    """(B, S, H) -> f32 (B, nh, S, hd)."""
    b, s, h = t.shape
    return t.float().reshape(b, s, nh, h // nh).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    b, nh, s, hd = t.shape
    return t.transpose(1, 2).reshape(b, s, nh * hd)


def _probs(q, k, key_mask, causal: bool, nh: int) -> torch.Tensor:
    """f32 softmax probabilities (B, nh, Sq, Sk) before dropout."""
    b, sq, H = q.shape
    sk = k.shape[1]
    s = _heads(q, nh) @ _heads(k, nh).transpose(-1, -2) * (1.0 / math.sqrt(H // nh))
    ok = torch.ones((b, 1, sq, sk), dtype=torch.bool, device=q.device)
    if key_mask is not None:
        ok = ok & (key_mask[:, None, None, :] > 0)
    if causal:
        ok = ok & torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril()
    s = s + torch.where(ok, 0.0, NEG_INF)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _attn_keep(seed, op_base, nh, b, sq, sk, rate, device) -> torch.Tensor | None:
    """(B, nh, Sq, Sk) keep/scale mask, or None without dropout."""
    if rate <= 0.0:
        return None
    return torch.stack([attention_keep(seed, op_base + h, b, sq, sk, rate, device)
                        for h in range(nh)], dim=1)


def _attention(q, k, v, key_mask, causal: bool, nh: int, seed=0, op_base=0,
               rate=0.0) -> torch.Tensor:
    """Per-sentence attention. q (B, Sq, H), k/v (B, Sk, H) in the compute
    dtype; key_mask (B, Sk) or None. Returns the f32 context (B, Sq, H)."""
    b, sq, _ = q.shape
    p = _probs(q, k, key_mask, causal, nh)
    keep = _attn_keep(seed, op_base, nh, b, sq, k.shape[1], rate, q.device)
    if keep is not None:
        p = p * keep
    return _merge(p.to(q.dtype).float() @ _heads(v, nh))


def _hidden_keep(geom: LayerGeom, seed, op, rows, device):
    return hidden_keep(seed, op, rows, geom.hidden, geom.hid_rate, device)


def layer_forward_reference(geom: LayerGeom, x, enc, smask, cmask, weights, seed=0):
    """Plain forward of the kernel: ``(out, residuals)`` with the residuals
    in :func:`residual_names` order. x (B, S, H) and enc (B, S_k, H) in the
    compute dtype; smask (B, S) and cmask (B, S_k) key-validity ints or None."""
    W = dict(zip(_names(geom), weights))
    cdtype = x.dtype
    b, s, H = x.shape
    M, dev = b * s, x.device
    nh = geom.num_heads
    x2d = x.reshape(M, H)
    res = {}

    def keep(op):
        return _hidden_keep(geom, seed, op, M, dev) if geom.hid_rate > 0.0 else None

    qkv = (_mm(x2d, W["wqkv"]) + W["bqkv"]).to(cdtype)
    q3 = qkv.view(b, s, 3 * H)
    ctx = _attention(q3[..., :H], q3[..., H:2 * H], q3[..., 2 * H:], smask, geom.causal, nh,
                     seed, 0, geom.attn_rate).to(cdtype).reshape(M, H)
    x1, inv1 = residual_layernorm_reference(x2d, _mm(ctx, W["wo"]) + W["bo"], W["g1"], W["be1"],
                                            geom.eps, keep(OP_ATTN_OUT))
    res.update(qkv=qkv, ctx=ctx, x1=x1)
    inv2 = torch.zeros_like(inv1)
    xm = x1

    if geom.has_cross:
        sk = enc.shape[1]
        qc = (_mm(x1, W["wq"]) + W["bq"]).to(cdtype)
        kvc = (_mm(enc.reshape(b * sk, H), W["wkv"]) + W["bkv"]).to(cdtype)
        kv3 = kvc.view(b, sk, 2 * H)
        ctx2 = _attention(qc.view(b, s, H), kv3[..., :H], kv3[..., H:], cmask, False, nh,
                          seed, cross_op(nh), geom.attn_rate).to(cdtype).reshape(M, H)
        x2, inv2 = residual_layernorm_reference(x1, _mm(ctx2, W["wco"]) + W["bco"], W["g2"],
                                                W["be2"], geom.eps, keep(OP_CROSS_OUT))
        res.update(qc=qc, kvc=kvc, ctx2=ctx2, x2=x2)
        xm = x2

    u = _mm(xm, W["w1"]) + W["b1"]
    m = gelu(u, geom.gelu_exact).to(cdtype)
    out, inv3 = residual_layernorm_reference(xm, _mm(m, W["w2"]) + W["b2"], W["g3"], W["be3"],
                                             geom.eps, keep(OP_MLP_OUT))
    res.update(u=u.to(cdtype), m=m, invs=torch.stack([inv1, inv2, inv3]))
    return out.view(b, s, H), tuple(res[n] for n in residual_names(geom))


def bert_layer_reference(geom: LayerGeom, x, enc, smask, cmask, weights, seed=0) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (same dtype, same rounding points)."""
    return layer_forward_reference(geom, x, enc, smask, cmask, weights, seed)[0]


def _split_qkv(qkv_or_q, kv):
    """q, k, v views of a packed qkv (B, S, 3H) (``kv`` None) or of q (B, S, H)
    and a packed kv (B, S_k, 2H)."""
    if kv is None:
        H = qkv_or_q.shape[-1] // 3
        return qkv_or_q[..., :H], qkv_or_q[..., H:2 * H], qkv_or_q[..., 2 * H:]
    H = qkv_or_q.shape[-1]
    return qkv_or_q, kv[..., :H], kv[..., H:]


def attention_forward_reference(qkv_or_q, kv, key_mask, num_heads: int, causal: bool, seed=0,
                                op_base=0, rate=0.0) -> torch.Tensor:
    """Plain version of the layer forward's attention (``_attn_fwd_tile``
    l.244): the context (B, S, H) in the compute dtype. Self (``kv`` None):
    qkv (B, S, 3H); cross: q (B, S, H), kv (B, S_k, 2H). Heads drop with op
    ids ``op_base + h``."""
    q, k, v = _split_qkv(qkv_or_q, kv)
    return _attention(q, k, v, key_mask, causal, num_heads, seed, op_base, rate).to(q.dtype)


def attention_backward_reference(qkv_or_q, kv, key_mask, g_ctx, num_heads: int, causal: bool,
                                 seed=0, op_base=0, rate=0.0):
    """Plain version of the attention backward (``_attn_bwd_tile`` l.304),
    with the contract of ``_attn_bwd_call`` (l.730). Self (``kv`` None):
    qkv (B, S, 3H) -> dqkv (B, S, 3H). Cross: q (B, S, H), kv (B, S_k, 2H) ->
    (dq (B, S, H), dkv (B, S_k, 2H)). Outputs in the compute dtype."""
    q, k, v = _split_qkv(qkv_or_q, kv)
    dq, dk, dv = attention_grads(q, k, v, key_mask, g_ctx, num_heads, causal, seed, op_base, rate)
    if kv is None:
        return torch.cat([dq, dk, dv], dim=-1)
    return dq, torch.cat([dk, dv], dim=-1)


def attention_grads(q, k, v, key_mask, g_ctx, num_heads: int, causal: bool, seed=0, op_base=0,
                    rate=0.0):
    """dq, dk, dv of :func:`_attention` (``_sdpa_bwd_kernel``'s and
    ``_attn_bwd_tile``'s function): p recomputed from q and k, the keep mask
    on dv and dp, ds rounded to q's dtype before dq and dk; each gradient in
    q's dtype."""
    cdtype = q.dtype
    b, sq, H = q.shape
    nh = num_heads
    scale = 1.0 / math.sqrt(H // nh)
    p = _probs(q, k, key_mask, causal, nh)
    keep = _attn_keep(seed, op_base, nh, b, sq, k.shape[1], rate, q.device)
    pd = p if keep is None else p * keep
    gh = _heads(g_ctx.to(cdtype), nh)
    qh, kh, vh = _heads(q, nh), _heads(k, nh), _heads(v, nh)
    dv = pd.to(cdtype).float().transpose(-1, -2) @ gh
    dp = gh @ vh.transpose(-1, -2)
    if keep is not None:
        dp = dp * keep
    t = (dp * p).sum(-1, keepdim=True)
    ds = (p * (dp - t) * scale).to(cdtype).float()
    dq = _merge(ds @ kh).to(cdtype)
    dk = _merge(ds.transpose(-1, -2) @ qh).to(cdtype)
    return dq, dk, _merge(dv).to(cdtype)


def layer_backward_reference(geom: LayerGeom, x, enc, smask, cmask, weights, seed, res, out, gy,
                             enc_dtype=None):
    """Plain backward from the saved residuals (``_layer_backward_xla``
    l.1013): ``(dx, denc, dweights)``; dx in the compute dtype, denc in
    ``enc_dtype`` (the dtype the caller's enc had), each weight gradient in
    its weight's dtype, summed over all rows in f32."""
    W = dict(zip(_names(geom), weights))
    R = dict(zip(residual_names(geom), res))
    cdtype = x.dtype
    b, s, H = x.shape
    M, dev = b * s, x.device
    nh = geom.num_heads
    inv1, inv2, inv3 = R["invs"]
    x2d = x.reshape(M, H)
    gy2 = gy.reshape(M, H).float()
    dW = {}

    def keep(op):
        return _hidden_keep(geom, seed, op, M, dev) if geom.hid_rate > 0.0 else None

    def ln_block(g_up, v, inv, gname, bname, bias, op):
        dr, da, dW[gname], dW[bname], dW[bias] = layernorm_backward_reference(
            g_up, v, inv, W[gname], W[bname], keep(op))
        return dr, da

    # MLP block
    dr3, dy = ln_block(gy2, out.reshape(M, H), inv3, "g3", "be3", "b2", OP_MLP_OUT)
    dy_c = dy.to(cdtype)
    dW["w2"] = _mm_tn(R["m"], dy_c)
    du = _mm_nt(dy_c, W["w2"]) * gelu_grad(R["u"].float(), geom.gelu_exact)
    du_c = du.to(cdtype)
    xm = R["x2"] if geom.has_cross else R["x1"]
    dW["w1"] = _mm_tn(xm, du_c)
    dW["b1"] = column_sums_reference(du)
    dxm = dr3 + _mm_nt(du_c, W["w1"])

    denc = None
    if geom.has_cross:
        sk = enc.shape[1]
        dr2, da2 = ln_block(dxm, R["x2"], inv2, "g2", "be2", "bco", OP_CROSS_OUT)
        da2_c = da2.to(cdtype)
        dW["wco"] = _mm_tn(R["ctx2"], da2_c)
        dctx2 = _mm_nt(da2_c, W["wco"]).to(cdtype)
        dqc, dkv = attention_backward_reference(
            R["qc"].view(b, s, H), R["kvc"].view(b, sk, 2 * H), cmask, dctx2.view(b, s, H), nh,
            False, seed, cross_op(nh), geom.attn_rate)
        dqc, dkv = dqc.reshape(M, H), dkv.reshape(b * sk, 2 * H)
        dW["wq"] = _mm_tn(R["x1"], dqc)
        dW["bq"] = column_sums_reference(dqc)
        dW["wkv"] = _mm_tn(enc.reshape(b * sk, H), dkv)
        dW["bkv"] = column_sums_reference(dkv)
        denc = _mm_nt(dkv, W["wkv"]).reshape(b, sk, H).to(enc_dtype or cdtype)
        dx1 = dr2 + _mm_nt(dqc, W["wq"])
    else:
        dx1 = dxm

    dr1, da1 = ln_block(dx1, R["x1"], inv1, "g1", "be1", "bo", OP_ATTN_OUT)
    da1_c = da1.to(cdtype)
    dW["wo"] = _mm_tn(R["ctx"], da1_c)
    dctx = _mm_nt(da1_c, W["wo"]).to(cdtype)
    dqkv = attention_backward_reference(R["qkv"].view(b, s, 3 * H), None, smask,
                                        dctx.view(b, s, H), nh, geom.causal, seed, 0,
                                        geom.attn_rate).reshape(M, 3 * H)
    dW["wqkv"] = _mm_tn(x2d, dqkv)
    dW["bqkv"] = column_sums_reference(dqkv)
    dx = (dr1 + _mm_nt(dqkv, W["wqkv"])).reshape(b, s, H).to(cdtype)
    return dx, denc, tuple(dW[n].to(W[n].dtype) for n in _names(geom))


# ---------------------------------------------------------------- CUDA wrappers


_VP, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_FWD_ARGTYPES = [_VP] * 36 + [_I] * 9 + [_F, _U, _U, _F, _U, _F, _VP, _I, _I]
_DTYPES = (torch.bfloat16, torch.float32)  # the compute dtypes the kernels take


@functools.lru_cache(maxsize=64)
def _slots(geom: LayerGeom) -> tuple[int, ...]:
    """Each weight's place in DEC_WEIGHTS."""
    return tuple(DEC_WEIGHTS.index(n) for n in _names(geom))


@functools.lru_cache(maxsize=256)
def _tile_n(M: int, Mk: int, H: int, F: int, gelu_exact: bool, sms: int):
    """The tile width of each product of the forward, in the C sequence's
    order: qkv, wo, wq, wkv (over the encoder's ``Mk`` rows), wco, w1, w2."""
    gelu_epi = "gelu_erf" if gelu_exact else "gelu_tanh"
    products = (((M, 3 * H, H), "bf16"), ((M, H, H), "f32"), ((M, H, H), "bf16"),
                ((Mk, 2 * H, H), "bf16"), ((M, H, H), "f32"), ((M, F, H), gelu_epi),
                ((M, H, F), "f32"))
    return (ctypes.c_int * 7)(*(gemm_plan(*shape, False, sms, epi).tile_n
                                for shape, epi in products))


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _check_call(geom: LayerGeom, seed) -> None:
    for what, rate in (("attn_rate", geom.attn_rate), ("hid_rate", geom.hid_rate)):
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout {what} must lie in [0, 1), got {rate}")
    if geom.dropout and seed is None:
        raise ValueError("dropout inside the fused layer needs a seed (an int32)")


def _check_layer_inputs(geom: LayerGeom, x, enc, smask, cmask, weights) -> int:
    """Validate a kernel call; returns s_k."""
    dev = x.device
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, H), got {tuple(x.shape)}")
    b, s, H = x.shape
    if H != geom.hidden:
        raise ValueError(f"x width {H} != num_heads * head_dim = {geom.hidden}")
    if geom.head_dim > MAX_HEAD_DIM or H % 8 or geom.intermediate % 8 or H > MAX_LN_WIDTH:
        raise ValueError(f"the layer kernels need head_dim <= {MAX_HEAD_DIM}, a width of at most "
                         f"{MAX_LN_WIDTH} and widths divisible by 8")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x has dtype {x.dtype}; the layer kernels take torch.bfloat16 or "
                        "torch.float32")
    cdtype = x.dtype
    _build.check_tensor("x", x, (b, s, H), cdtype, dev)
    specs = _weight_specs(geom)
    if len(weights) != len(specs):
        raise ValueError(f"expected {len(specs)} weights ({_names(geom)}), got {len(weights)}")
    f32 = torch.float32
    for (n, shape, kernel, ln), w in zip(specs, weights):
        # matmul kernels in the compute dtype (on 16 bytes in bf16); biases and
        # LayerNorm parameters stay f32, the LayerNorm's on 16 bytes (the
        # LayerNorm kernels load them so). The named checks below raise with
        # the reason; this test only decides whether to run them.
        dtype = cdtype if kernel else f32
        if (w.dtype is not dtype or w.shape != shape or w.device != dev
                or not w.is_contiguous()
                or ((ln or (kernel and dtype is torch.bfloat16)) and w.data_ptr() % 16)):
            if ln:
                _check_f32(n, w, shape, dev)
            else:
                _build.check_tensor(n, w, shape, dtype, dev)
    sk = s
    if geom.has_cross:
        if enc is None:
            raise ValueError("a decoder layer needs enc")
        sk = enc.shape[1]
        _build.check_tensor("enc", enc, (b, sk, H), cdtype, dev)
    elif enc is not None:
        raise ValueError("enc given to a layer without cross-attention")
    if s > MAX_SEQ or sk > MAX_SEQ or s == 0 or b == 0:
        raise ValueError(f"sequence lengths must be in 1..{MAX_SEQ}, got {s} and {sk}")
    if smask is not None:
        _build.check_tensor("smask", smask, (b, s), torch.int32, dev)
    if cmask is not None:
        if not geom.has_cross:
            raise ValueError("cmask given to a layer without cross-attention")
        _build.check_tensor("cmask", cmask, (b, sk), torch.int32, dev)
    return sk


def _launch(geom: LayerGeom, x, enc, smask, cmask, weights, seed, save: bool):
    """Run ``csrc/layer_fwd.cu``: the output, plus the residuals when ``save``."""
    sk = _check_layer_inputs(geom, x, enc, smask, cmask, weights)
    dev = x.device
    b, s, H = x.shape
    M, F = b * s, geom.intermediate
    wptr = [None] * len(DEC_WEIGHTS)  # the C sequence takes DEC_WEIGHTS, unused ones null
    for i, w in zip(_slots(geom), weights):
        wptr[i] = w.data_ptr()
    f32 = int(x.dtype == torch.float32)

    def ws(shape, dtype=x.dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    qkv, ctx, acc, x1, m, out = (ws((M, 3 * H)), ws((M, H)), ws((M, H), torch.float32),
                                 ws((M, H)), ws((M, F)), ws((b, s, H)))
    qc = kvc = x2 = ctx2 = u = invs = None
    if geom.has_cross:
        qc, kvc, x2 = ws((M, H)), ws((b * sk, 2 * H)), ws((M, H))
    if save:
        u, invs = ws((M, F)), torch.zeros((3, M), dtype=torch.float32, device=dev)
        if geom.has_cross:
            ctx2 = ws((M, H))

    sms = sm_count(dev)
    tile_n = _tile_n(M, b * sk, H, F, geom.gelu_exact, sms)
    _build.launch(
        "kvq_bert_layer_fwd", _FWD_ARGTYPES,
        _ptr(x), _ptr(enc), _ptr(smask), _ptr(cmask),
        *wptr,
        _ptr(qkv), _ptr(ctx), _ptr(ctx2), _ptr(acc), _ptr(x1), _ptr(qc), _ptr(kvc), _ptr(x2),
        _ptr(m), _ptr(u), _ptr(invs), _ptr(out),
        b, s, sk, geom.num_heads, geom.head_dim, F,
        int(geom.causal), int(geom.has_cross), int(geom.gelu_exact), geom.eps,
        seed_u32(seed or 0), keep_threshold(geom.attn_rate), keep_scale(geom.attn_rate),
        keep_threshold(geom.hid_rate), keep_scale(geom.hid_rate), tile_n, sms, f32,
        device=dev,
    )
    n_gemm, n_attn, n_ln = layer_gemms(geom)[0], 1 + int(geom.has_cross), 2 + int(geom.has_cross)
    gemm.launches += n_gemm
    gemm.forward_launches += n_gemm
    gemm.f32_launches += f32 * n_gemm
    attention_forward.launches += n_attn
    attention_forward.cross_launches += int(geom.has_cross)
    attention_forward.f32_launches += f32 * n_attn
    residual_layernorm.launches += n_ln
    residual_layernorm.f32_launches += f32 * n_ln
    fused_bert_layer.launches += 1
    fused_bert_layer.residual_launches += int(save)
    fused_bert_layer.f32_launches += f32
    if not save:
        return out, None
    res = dict(qkv=qkv, ctx=ctx, x1=x1, qc=qc, kvc=kvc, ctx2=ctx2, x2=x2, u=u, m=m, invs=invs)
    return out, tuple(res[n] for n in residual_names(geom))


def layer_forward(geom: LayerGeom, x, enc, smask, cmask, weights, seed):
    """Training forward of one layer: ``(out, residuals)``, the residuals in
    :func:`residual_names` order. A CPU tensor takes
    :func:`layer_forward_reference`; a CUDA tensor launches
    ``csrc/layer_fwd.cu`` (bf16 or f32) or raises, adding one to
    ``fused_bert_layer.launches``."""
    _check_call(geom, seed)
    if x.device.type == "cpu":
        return layer_forward_reference(geom, x, enc, smask, cmask, weights, seed or 0)
    if x.device.type != "cuda":
        raise ValueError(f"layer_forward runs on CPU or CUDA tensors, got {x.device}")
    return _launch(geom, x, enc, smask, cmask, weights, seed, save=True)


def _attention_args(qkv_or_q, kv, key_mask, num_heads: int, rate: float, what: str):
    """Check an attention kernel call (bf16 or f32); returns (b, sq, sk, H)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    dev = qkv_or_q.device
    cross = kv is not None
    b, sq, w = qkv_or_q.shape
    H = w if cross else w // 3
    sk = kv.shape[1] if cross else sq
    if H % num_heads or H // num_heads > MAX_HEAD_DIM or sq > MAX_SEQ or sk > MAX_SEQ or b == 0:
        raise ValueError(f"{what} takes head_dim <= {MAX_HEAD_DIM} and sequences of 1..{MAX_SEQ}")
    if qkv_or_q.dtype not in _DTYPES:
        raise TypeError(f"{what} takes torch.bfloat16 or torch.float32, got {qkv_or_q.dtype}")
    _build.check_tensor("qkv_or_q", qkv_or_q, (b, sq, w), qkv_or_q.dtype, dev)
    if cross:
        _build.check_tensor("kv", kv, (b, sk, 2 * H), qkv_or_q.dtype, dev)
    if key_mask is not None:
        _build.check_tensor("key_mask", key_mask, (b, sk), torch.int32, dev)
    return b, sq, sk, H


def attention_forward(qkv_or_q, kv, key_mask, num_heads: int, causal: bool, seed=0, op_base=0,
                      rate=0.0) -> torch.Tensor:
    """The attention of the fused layer forward alone (``_attn_fwd_tile``,
    ``layer_pallas.py:244``, inside ``_layer_fwd_kernel`` l.489), with the
    contract of :func:`attention_forward_reference`. A CPU tensor takes the
    plain version; a CUDA tensor launches ``kvq_attention_fwd`` of
    ``csrc/layer_fwd.cu`` (bf16, or f32 through ``csrc/attention_f32.cuh``)
    or raises. ``attention_forward.launches`` counts these launches and those
    inside :func:`fused_bert_layer`'s forward launches (one self-attention
    each, and one cross-attention in a decoder layer, counted also in
    ``attention_forward.cross_launches``)."""
    if qkv_or_q.device.type == "cpu":
        return attention_forward_reference(qkv_or_q, kv, key_mask, num_heads, causal, seed,
                                           op_base, rate)
    if qkv_or_q.device.type != "cuda":
        raise ValueError(f"attention_forward runs on CPU or CUDA tensors, got {qkv_or_q.device}")
    b, sq, sk, H = _attention_args(qkv_or_q, kv, key_mask, num_heads, rate, "attention_forward")
    cross = kv is not None
    dev = qkv_or_q.device
    es, f32 = qkv_or_q.element_size(), int(qkv_or_q.dtype == torch.float32)
    ctx = torch.empty((b, sq, H), dtype=qkv_or_q.dtype, device=dev)
    q_ld, kv_ld = (H, 2 * H) if cross else (3 * H, 3 * H)
    k_ptr = kv.data_ptr() if cross else qkv_or_q.data_ptr() + es * H
    _build.launch("kvq_attention_fwd", _ATT_FWD_ARGS, qkv_or_q.data_ptr(), q_ld, k_ptr,
                  k_ptr + es * H, kv_ld, _ptr(key_mask), ctx.data_ptr(), H, b, num_heads,
                  H // num_heads, sq, sk, int(causal), seed_u32(seed), keep_threshold(rate),
                  keep_scale(rate), op_base, f32, device=dev)
    attention_forward.launches += 1
    attention_forward.cross_launches += int(cross)
    attention_forward.f32_launches += f32
    return ctx


attention_forward.launches = 0
attention_forward.cross_launches = 0  # the cross-attention share of ``launches``
attention_forward.f32_launches = 0  # the f32 share of ``launches``
_ATT_FWD_ARGS = [_VP, _I, _VP, _VP, _I, _VP, _VP, _I] + [_I] * 6 + [_U, _U, _F, _I, _I]


def attention_backward(qkv_or_q, kv, key_mask, g_ctx, num_heads: int, causal: bool,
                       seed=0, op_base=0, rate=0.0):
    """The attention backward of the fused layer, self and cross, with the
    contract of :func:`attention_backward_reference`. Replaces the TPU
    kernels ``_attn_bwd_self_kernel`` / ``_attn_bwd_cross_kernel``
    (``layer_pallas.py:696/712``). A CPU tensor takes the plain version; a
    CUDA tensor launches ``csrc/layer_bwd.cu`` (bf16, or f32 through
    ``csrc/attention_f32.cuh``) or raises, and each launch adds one to
    ``attention_backward.launches`` (and, for cross-attention, to
    ``attention_backward.cross_launches``; in f32 to its ``f32_launches``)."""
    if qkv_or_q.device.type == "cpu":
        return attention_backward_reference(qkv_or_q, kv, key_mask, g_ctx, num_heads, causal,
                                            seed, op_base, rate)
    if qkv_or_q.device.type != "cuda":
        raise ValueError(f"attention_backward runs on CPU or CUDA tensors, got {qkv_or_q.device}")
    b, sq, sk, H = _attention_args(qkv_or_q, kv, key_mask, num_heads, rate, "attention_backward")
    dev = qkv_or_q.device
    cross = kv is not None
    nh, dtype = num_heads, qkv_or_q.dtype
    es, f32 = qkv_or_q.element_size(), int(dtype == torch.float32)
    _build.check_tensor("g_ctx", g_ctx, (b, sq, H), dtype, dev)
    if cross:
        dq = torch.empty((b, sq, H), dtype=dtype, device=dev)
        dkv = torch.empty((b, sk, 2 * H), dtype=dtype, device=dev)
        q, q_ld, k, kv_ld = qkv_or_q, H, kv, 2 * H
        dq_ptr, dq_ld, dk_ptr, dkv_ld = dq.data_ptr(), H, dkv.data_ptr(), 2 * H
    else:
        dqkv = torch.empty((b, sq, 3 * H), dtype=dtype, device=dev)
        q, q_ld, k, kv_ld = qkv_or_q, 3 * H, None, 3 * H
        dq_ptr, dq_ld, dk_ptr, dkv_ld = dqkv.data_ptr(), 3 * H, dqkv.data_ptr() + es * H, 3 * H
    k_ptr = k.data_ptr() if cross else q.data_ptr() + es * H
    _build.launch("kvq_attention_bwd", _ATT_BWD_ARGS, q.data_ptr(), q_ld, k_ptr, k_ptr + es * H,
                  kv_ld, _ptr(key_mask), g_ctx.data_ptr(), dq_ptr, dq_ld, dk_ptr,
                  dk_ptr + es * H, dkv_ld, b, nh, H // nh, sq, sk, int(causal), seed_u32(seed),
                  keep_threshold(rate), keep_scale(rate), op_base, f32, device=dev)
    attention_backward.launches += 1
    attention_backward.cross_launches += int(cross)
    attention_backward.f32_launches += f32
    return (dq, dkv) if cross else dqkv


attention_backward.launches = 0
attention_backward.cross_launches = 0  # the cross-attention share of ``launches``
attention_backward.f32_launches = 0  # the f32 share of ``launches``
_ATT_BWD_ARGS = [_VP, _I, _VP, _VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _I] + [_I] * 6 + [_U, _U, _F,
                                                                                     _I, _I]

# csrc/layernorm.cu: rows per block of the LayerNorm backward's partials
# (LNB_ROWS) and of the column sums' (CS_ROWS)
LN_BWD_ROWS = 64
COLSUM_ROWS = 256
_RES_LN_ARGS = [_VP] * 6 + [_I, _I, _F, _U, _U, _F, _U, _I]
_LN_BWD_ARGS = [_VP, _I] + [_VP] * 4 + [_U, _U, _F, _U] + [_VP] * 4 + [_I, _I, _I]
_COLSUM_ARGS = [_VP, _I, _I, _VP, _VP, _I]


def _check_f32(name, t, shape, dev) -> None:
    _build.check_tensor(name, t, shape, torch.float32, dev)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (16-byte loads)")


def _check_rows(name, t, shape, dev) -> None:
    """A bf16 or f32 (rows, N) operand of the LayerNorm and column-sum kernels."""
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernels take torch.bfloat16 or "
                        "torch.float32")
    _build.check_tensor(name, t, shape, t.dtype, dev)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (16-byte loads)")


def _check_ln_width(N: int, what: str) -> None:
    if N % 8 or not 0 < N <= MAX_LN_WIDTH:
        raise ValueError(f"{what} takes rows of a multiple of 8 columns, at most {MAX_LN_WIDTH}; "
                         f"got {N}")


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")


def residual_layernorm(x, a, gamma, beta, eps: float, seed=0, op=OP_ATTN_OUT, rate=0.0):
    """Residual + post-LN of the fused layer forward (``_ln_fwd`` l.164
    inside ``_layer_fwd_kernel`` l.489): ``(out, inv)`` with the contract of
    :func:`residual_layernorm_reference`, the keep mask that of the hidden
    site ``op`` over rows 0..M-1 (``rate`` 0: none). A CPU tensor takes the
    plain version; a CUDA tensor launches ``kvq_residual_layernorm`` of
    ``csrc/layernorm.cu`` (x bf16 or f32 (M, N), a f32, N a multiple of 8 up
    to :data:`MAX_LN_WIDTH`) or raises. ``residual_layernorm.launches``
    counts these launches and those inside the layer forward's C sequence (2
    a layer forward, 3 with cross-attention)."""
    _check_rate(rate)
    if x.device.type == "cpu":
        keep = hidden_keep(seed, op, x.shape[0], x.shape[1], rate) if rate > 0.0 else None
        return residual_layernorm_reference(x, a, gamma, beta, eps, keep)
    if x.device.type != "cuda":
        raise ValueError(f"residual_layernorm runs on CPU or CUDA tensors, got {x.device}")
    dev = x.device
    if x.dim() != 2:
        raise ValueError(f"x must be (M, N), got {tuple(x.shape)}")
    M, N = x.shape
    _check_ln_width(N, "residual_layernorm")
    _check_rows("x", x, (M, N), dev)
    _check_f32("a", a, (M, N), dev)
    _check_f32("gamma", gamma, (N,), dev)
    _check_f32("beta", beta, (N,), dev)
    f32 = int(x.dtype == torch.float32)
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    inv = torch.empty((M,), dtype=torch.float32, device=dev)
    _build.launch("kvq_residual_layernorm", _RES_LN_ARGS, x.data_ptr(), a.data_ptr(),
                  gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), inv.data_ptr(), M, N, eps,
                  seed_u32(seed), keep_threshold(rate), keep_scale(rate), op, f32, device=dev)
    residual_layernorm.launches += 1
    residual_layernorm.f32_launches += f32
    return out, inv


residual_layernorm.launches = 0
residual_layernorm.f32_launches = 0


def layernorm_backward(gy, v, inv, gamma, beta, seed=0, op=OP_ATTN_OUT, rate=0.0):
    """LayerNorm backward of the fused layer (``_ln_recover_yhat`` l.542 and
    ``_ln_bwd`` l.175 inside ``_layer_bwd_kernel`` l.552) with its column
    sums: ``(dr, da, dgamma, dbeta, dbias)`` with the contract of
    :func:`layernorm_backward_reference`, dr f32, da in v's dtype, the sums
    f32; the keep mask that of the hidden site ``op`` over rows 0..M-1. A
    CPU tensor takes the plain version; a CUDA
    tensor launches ``kvq_ln_bwd`` of ``csrc/layernorm.cu`` (v bf16 (M, N)
    with gy bf16 or f32, or v and gy f32; N a multiple of 8 up to
    :data:`MAX_LN_WIDTH`) or raises, adding one to
    ``layernorm_backward.launches``. The sums are the same bits in every
    run."""
    _check_rate(rate)
    if v.device.type == "cpu":
        keep = hidden_keep(seed, op, v.shape[0], v.shape[1], rate) if rate > 0.0 else None
        dr, da, *sums = layernorm_backward_reference(gy, v, inv, gamma, beta, keep)
        return (dr, da.to(v.dtype), *sums)
    if v.device.type != "cuda":
        raise ValueError(f"layernorm_backward runs on CPU or CUDA tensors, got {v.device}")
    dev = v.device
    if v.dim() != 2:
        raise ValueError(f"v must be (M, N), got {tuple(v.shape)}")
    M, N = v.shape
    _check_ln_width(N, "layernorm_backward")
    _check_rows("v", v, (M, N), dev)
    f32 = int(v.dtype == torch.float32)
    if f32 and gy.dtype != torch.float32:
        raise TypeError(f"an f32 v takes an f32 gy, got {gy.dtype}")
    _check_rows("gy", gy, (M, N), dev)
    _build.check_tensor("inv", inv, (M,), torch.float32, dev)
    _build.check_tensor("gamma", gamma, (N,), torch.float32, dev)
    _build.check_tensor("beta", beta, (N,), torch.float32, dev)
    dr = torch.empty((M, N), dtype=torch.float32, device=dev)
    da = torch.empty((M, N), dtype=v.dtype, device=dev)
    parts = torch.empty((-(-M // LN_BWD_ROWS), 3, N), dtype=torch.float32, device=dev)
    sums = torch.empty((3, N), dtype=torch.float32, device=dev)
    _build.launch("kvq_ln_bwd", _LN_BWD_ARGS, gy.data_ptr(), int(gy.dtype == torch.float32),
                  v.data_ptr(), inv.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                  seed_u32(seed), keep_threshold(rate), keep_scale(rate), op, dr.data_ptr(),
                  da.data_ptr(), parts.data_ptr(), sums.data_ptr(), M, N, f32, device=dev)
    layernorm_backward.launches += 1
    layernorm_backward.f32_launches += f32
    return dr, da, sums[0], sums[1], sums[2]


layernorm_backward.launches = 0
layernorm_backward.f32_launches = 0


def column_sums(src):
    """f32 column sums of a (rows, N) matrix, a bias gradient of the fused
    layer backward (``_layer_bwd_kernel`` l.552), with the contract of
    :func:`column_sums_reference`. A CPU tensor takes the plain version; a
    CUDA tensor launches ``kvq_colsum`` of ``csrc/layernorm.cu`` (bf16 or
    f32, N a multiple of 8) or raises, adding one to
    ``column_sums.launches``. The sums are the same bits in every run."""
    if src.device.type == "cpu":
        return column_sums_reference(src)
    if src.device.type != "cuda":
        raise ValueError(f"column_sums runs on CPU or CUDA tensors, got {src.device}")
    dev = src.device
    if src.dim() != 2 or src.shape[0] == 0 or src.shape[1] % 8 or src.shape[1] == 0:
        raise ValueError(f"column_sums takes (rows, N) with rows >= 1 and N a multiple of 8, got "
                         f"{tuple(src.shape)}")
    M, N = src.shape
    _check_rows("src", src, (M, N), dev)
    f32 = int(src.dtype == torch.float32)
    parts = torch.empty((-(-M // COLSUM_ROWS), N), dtype=torch.float32, device=dev)
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    _build.launch("kvq_colsum", _COLSUM_ARGS, src.data_ptr(), M, N, parts.data_ptr(),
                  out.data_ptr(), f32, device=dev)
    column_sums.launches += 1
    column_sums.f32_launches += f32
    return out


column_sums.launches = 0
column_sums.f32_launches = 0


def _backward_launch(geom: LayerGeom, x, enc, smask, cmask, weights, seed, res, out, gy,
                     enc_dtype):
    """The kernel backward: the same sequence as :func:`layer_backward_reference`.
    In f32 every product's output is f32: the casts to the compute dtype
    (``cast``, ``add_c``) are the f32 epilogues."""
    W = dict(zip(_names(geom), weights))
    R = dict(zip(residual_names(geom), res))
    dev, cdtype = x.device, x.dtype
    b, s, H = x.shape
    M, nh = b * s, geom.num_heads
    inv1, inv2, inv3 = R["invs"]
    seed, hr = seed or 0, geom.hid_rate
    gy = gy.contiguous()
    if gy.dtype != cdtype or gy.shape != x.shape:
        raise TypeError(f"the layer's output gradient must be {cdtype} {tuple(x.shape)}")
    f32 = cdtype == torch.float32
    cast, add_c = ("f32", "add_f32") if f32 else ("bf16", "add_bf16")
    dW = {}
    with torch.cuda.device(dev):
        # MLP block
        dr3, dy_c, dW["g3"], dW["be3"], dW["b2"] = layernorm_backward(
            gy.view(M, H), out.view(M, H), inv3, W["g3"], W["be3"], seed, OP_MLP_OUT, hr)
        dW["w2"] = gemm(R["m"], dy_c, a_t=True, epi=cast)
        du_c, dW["b1"] = gemm(dy_c, W["w2"], b_t=True,
                              epi="dgelu_erf" if geom.gelu_exact else "dgelu_tanh", aux=R["u"],
                              colsum=True)
        xm = R["x2"] if geom.has_cross else R["x1"]
        dW["w1"] = gemm(xm, du_c, a_t=True, epi=cast)
        dxm = gemm(du_c, W["w1"], b_t=True, epi="add_f32", aux=dr3)
        del du_c, dr3
        denc = None
        if geom.has_cross:
            sk = enc.shape[1]
            dr2, da2_c, dW["g2"], dW["be2"], dW["bco"] = layernorm_backward(
                dxm, R["x2"], inv2, W["g2"], W["be2"], seed, OP_CROSS_OUT, hr)
            dW["wco"] = gemm(R["ctx2"], da2_c, a_t=True, epi=cast)
            dctx2 = gemm(da2_c, W["wco"], b_t=True, epi=cast)
            dqc, dkv = attention_backward(R["qc"].view(b, s, H), R["kvc"].view(b, sk, 2 * H),
                                          cmask, dctx2.view(b, s, H), nh, False, seed,
                                          cross_op(nh), geom.attn_rate)
            dqc, dkv = dqc.view(M, H), dkv.view(b * sk, 2 * H)
            dW["wq"] = gemm(R["x1"], dqc, a_t=True, epi=cast)
            dW["bq"] = column_sums(dqc)
            dW["wkv"] = gemm(enc.view(b * sk, H), dkv, a_t=True, epi=cast)
            dW["bkv"] = column_sums(dkv)
            denc_epi = "f32" if f32 or enc_dtype == torch.float32 else "bf16"
            denc = gemm(dkv, W["wkv"], b_t=True, epi=denc_epi).view(b, sk, H).to(
                enc_dtype or cdtype)
            dx1 = gemm(dqc, W["wq"], b_t=True, epi="add_f32", aux=dr2)
            del dr2
        else:
            dx1 = dxm
        # self-attention block
        dr1, da1_c, dW["g1"], dW["be1"], dW["bo"] = layernorm_backward(
            dx1, R["x1"], inv1, W["g1"], W["be1"], seed, OP_ATTN_OUT, hr)
        dW["wo"] = gemm(R["ctx"], da1_c, a_t=True, epi=cast)
        dctx = gemm(da1_c, W["wo"], b_t=True, epi=cast)
        dqkv = attention_backward(R["qkv"].view(b, s, 3 * H), None, smask, dctx.view(b, s, H),
                                  nh, geom.causal, seed, 0, geom.attn_rate).view(M, 3 * H)
        dW["wqkv"] = gemm(x.view(M, H), dqkv, a_t=True, epi=cast)
        dW["bqkv"] = column_sums(dqkv)
        dx = gemm(dqkv, W["wqkv"], b_t=True, epi=add_c, aux=dr1).view(b, s, H)
    layer_backward.launches += 1
    layer_backward.f32_launches += int(f32)
    return dx, denc, tuple(dW[n] for n in _names(geom))


def layer_backward(geom: LayerGeom, x, enc, smask, cmask, weights, seed, res, out, gy,
                   enc_dtype=None):
    """Backward of one fused layer from its saved residuals: ``(dx, denc,
    dweights)``. Replaces the TPU kernel ``_layer_bwd_kernel``
    (``layer_pallas.py:552``). A CPU tensor takes
    :func:`layer_backward_reference`; a CUDA tensor runs ``csrc/layer_bwd.cu``
    (bf16 or f32) or raises, and each call adds one to
    ``layer_backward.launches``."""
    if x.device.type == "cpu":
        return layer_backward_reference(geom, x, enc, smask, cmask, weights, seed, res, out, gy,
                                        enc_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"layer_backward runs on CPU or CUDA tensors, got {x.device}")
    _check_layer_inputs(geom, x, enc, smask, cmask, weights)
    return _backward_launch(geom, x, enc, smask, cmask, weights, seed, res, out, gy, enc_dtype)


layer_backward.launches = 0
layer_backward.f32_launches = 0  # the f32 share of ``launches``


class FusedBertLayer(torch.autograd.Function):
    """One fused layer under autograd: the training forward keeps the
    residuals, the backward is :func:`layer_backward` (or, with
    ``reference``, the plain backward on any device)."""

    @staticmethod
    def forward(ctx, geom, reference, seed, x, enc, smask, cmask, *weights):
        enc_c = None if enc is None else enc.to(x.dtype).contiguous()
        fwd = layer_forward_reference if reference else layer_forward
        out, res = fwd(geom, x, enc_c, smask, cmask, weights, seed)
        ctx.geom, ctx.reference, ctx.seed = geom, reference, seed
        ctx.enc_dtype = None if enc is None else enc.dtype
        ctx.n_res = len(res)
        ctx.save_for_backward(x, enc_c, smask, cmask, out, *res, *weights)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, enc_c, smask, cmask, out, *rest = ctx.saved_tensors
        res, weights = tuple(rest[:ctx.n_res]), tuple(rest[ctx.n_res:])
        bwd = layer_backward_reference if ctx.reference else layer_backward
        dx, denc, dws = bwd(ctx.geom, x, enc_c, smask, cmask, weights, ctx.seed, res, out, gy,
                            ctx.enc_dtype)
        return (None, None, None, dx, denc, None, None, *dws)


def fused_bert_layer(geom: LayerGeom, x, enc, smask, cmask, weights, seed=None,
                     reference: bool = False) -> torch.Tensor:
    """One whole post-LN BERT layer. x (B, S, H); enc (B, S_k, H) or None,
    in any float dtype (it enters the layer in x's dtype, and its gradient
    comes back in its own); smask (B, S) / cmask (B, S_k) int32
    key-validity masks or None (all valid); ``weights`` in ENC_WEIGHTS /
    DEC_WEIGHTS order; ``seed`` the int32 of the hash dropout, needed when a
    rate in ``geom`` is above 0.

    When a gradient is needed the call runs :class:`FusedBertLayer`.
    Otherwise ``reference=True`` goes through :func:`bert_layer_reference`,
    and every other call through the custom op ``kvq::layer_fwd``: a CPU
    tensor takes the plain version, a CUDA tensor launches
    ``csrc/layer_fwd.cu`` (bf16 or f32) on the current stream, or raises; each
    forward launch adds one to ``fused_bert_layer.launches``, and each that
    keeps the residuals also to ``fused_bert_layer.residual_launches``."""
    weights = tuple(weights)
    _check_call(geom, seed)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_bert_layer runs on CPU or CUDA tensors, got {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, enc, *weights)):
        return FusedBertLayer.apply(geom, reference, seed or 0, x, enc, smask, cmask, *weights)
    if enc is not None and enc.dtype != x.dtype:
        enc = enc.to(x.dtype)
    if reference:
        return bert_layer_reference(geom, x, enc, smask, cmask, weights, seed or 0)
    return torch.ops.kvq.layer_fwd(x, enc, smask, cmask, weights, *_geom_args(geom), seed or 0)


fused_bert_layer.launches = 0
fused_bert_layer.residual_launches = 0  # of those, training launches that keep the residuals
fused_bert_layer.f32_launches = 0  # the f32 share of ``launches``


# The inference forward as the custom op ``kvq::layer_fwd``, which
# ``torch.export`` keeps as one node: on CPU tensors the plain version, on
# CUDA tensors ``csrc/layer_fwd.cu``; its fake implementation gives the
# output's shape and dtype and touches no memory. The geometry goes in as
# LayerGeom's fields, in their order.
_OPS = torch.library.Library("kvq", "FRAGMENT")
_OPS.define("layer_fwd(Tensor x, Tensor? enc, Tensor? smask, Tensor? cmask, Tensor[] weights, "
            "int num_heads, int head_dim, int intermediate, bool causal, bool has_cross, "
            "float eps, bool gelu_exact, float attn_rate, float hid_rate, int seed) -> Tensor")
_op_geom = functools.lru_cache(maxsize=64)(LayerGeom)


def _geom_args(geom: LayerGeom) -> tuple:
    return (geom.num_heads, geom.head_dim, geom.intermediate, geom.causal, geom.has_cross,
            geom.eps, geom.gelu_exact, geom.attn_rate, geom.hid_rate)


def _layer_fwd_cpu(x, enc, smask, cmask, weights, *geom_seed):
    return bert_layer_reference(_op_geom(*geom_seed[:-1]), x, enc, smask, cmask, weights,
                                geom_seed[-1])


def _layer_fwd_cuda(x, enc, smask, cmask, weights, *geom_seed):
    return _launch(_op_geom(*geom_seed[:-1]), x, enc, smask, cmask, weights, geom_seed[-1],
                   save=False)[0]


_OPS.impl("layer_fwd", _layer_fwd_cpu, "CPU")
_OPS.impl("layer_fwd", _layer_fwd_cuda, "CUDA")
torch.library.register_fake("kvq::layer_fwd", lambda x, *_: x.new_empty(x.shape), lib=_OPS)
