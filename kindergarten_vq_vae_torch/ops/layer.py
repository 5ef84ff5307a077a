"""One post-LN BertLayer, forward and backward: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``kindergarten_vq_vae_tpu/ops/layer_pallas.py``
(``fused_bert_layer`` l.1129, ``_layer_fwd_core`` l.374, ``_layer_bwd_kernel``
l.552, ``_attn_bwd_tile`` l.304). The forward kernel is ``csrc/layer_fwd.cu``,
the backward ``csrc/layer_bwd.cu``; :func:`layer_forward_reference`,
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
"""

from __future__ import annotations

import ctypes
import dataclasses
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

NEG_INF = -1e9
SQRT_2 = math.sqrt(2.0)
TANH_C = math.sqrt(2.0 / math.pi)
_ERF_P = (1.1283797055e+00, 1.0276548145e-01, -1.8438367938e-04,
          -6.2571958331e-04, 8.9712590414e-05, -5.9856910908e-06,
          1.5896024415e-07)

ENC_WEIGHTS = ("wqkv", "bqkv", "wo", "bo", "g1", "be1",
               "w1", "b1", "w2", "b2", "g3", "be3")
DEC_WEIGHTS = ("wqkv", "bqkv", "wo", "bo", "g1", "be1",
               "wq", "bq", "wkv", "bkv", "wco", "bco", "g2", "be2",
               "w1", "b1", "w2", "b2", "g3", "be3")

# limits of csrc/layer_fwd.cu's and layer_bwd.cu's attention kernels (ATT_MAX_S, ATT_MAX_HD)
MAX_SEQ = 32
MAX_HEAD_DIM = 128


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


def _erf_p(z2):
    acc = torch.full_like(z2, _ERF_P[-1])
    for c in _ERF_P[-2::-1]:
        acc = acc * z2 + c
    return acc


def _erf_dp(z2):
    """p'(z) as a polynomial in z^2 (``_erf_dp`` l.202)."""
    acc = torch.full_like(z2, 13.0 * _ERF_P[-1])
    for d, c in zip((11, 9, 7, 5, 3, 1), _ERF_P[-2::-1]):
        acc = acc * z2 + d * c
    return acc


def gelu(u: torch.Tensor, exact: bool) -> torch.Tensor:
    """f32 GELU as the kernel computes it (tanh-erf polynomial when exact)."""
    if exact:
        z = u / SQRT_2
        return 0.5 * u * (1.0 + torch.tanh(z * _erf_p(z * z)))
    w = TANH_C * (u + 0.044715 * u * u * u)
    return 0.5 * u * (1.0 + torch.tanh(w))


def gelu_grad(u: torch.Tensor, exact: bool) -> torch.Tensor:
    """d gelu / du of the form :func:`gelu` computes (``_gelu_grad`` l.221)."""
    if exact:
        z = u * (1.0 / SQRT_2)
        z2 = z * z
        t = torch.tanh(z * _erf_p(z2))
        return 0.5 * (1.0 + t) + (0.5 / SQRT_2) * u * (1.0 - t * t) * _erf_dp(z2)
    w = TANH_C * (u + 0.044715 * u * u * u)
    t = torch.tanh(w)
    return 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * TANH_C * (1.0 + 3.0 * 0.044715 * u * u)


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

    qkv = (_mm(x2d, W["wqkv"]) + W["bqkv"]).to(cdtype)
    q3 = qkv.view(b, s, 3 * H)
    ctx = _attention(q3[..., :H], q3[..., H:2 * H], q3[..., 2 * H:], smask, geom.causal, nh,
                     seed, 0, geom.attn_rate).to(cdtype).reshape(M, H)
    a1 = _mm(ctx, W["wo"]) + W["bo"]
    if geom.hid_rate > 0.0:
        a1 = a1 * _hidden_keep(geom, seed, OP_ATTN_OUT, M, dev)
    x1f, inv1 = _ln(x2d.float() + a1, W["g1"], W["be1"], geom.eps)
    x1 = x1f.to(cdtype)
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
        a2 = _mm(ctx2, W["wco"]) + W["bco"]
        if geom.hid_rate > 0.0:
            a2 = a2 * _hidden_keep(geom, seed, OP_CROSS_OUT, M, dev)
        x2f, inv2 = _ln(x1.float() + a2, W["g2"], W["be2"], geom.eps)
        x2 = x2f.to(cdtype)
        res.update(qc=qc, kvc=kvc, ctx2=ctx2, x2=x2)
        xm = x2

    u = _mm(xm, W["w1"]) + W["b1"]
    m = gelu(u, geom.gelu_exact).to(cdtype)
    y = _mm(m, W["w2"]) + W["b2"]
    if geom.hid_rate > 0.0:
        y = y * _hidden_keep(geom, seed, OP_MLP_OUT, M, dev)
    outf, inv3 = _ln(xm.float() + y, W["g3"], W["be3"], geom.eps)
    res.update(u=u.to(cdtype), m=m, invs=torch.stack([inv1, inv2, inv3]))
    return outf.to(cdtype).view(b, s, H), tuple(res[n] for n in residual_names(geom))


def bert_layer_reference(geom: LayerGeom, x, enc, smask, cmask, weights, seed=0) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (same dtype, same rounding points)."""
    return layer_forward_reference(geom, x, enc, smask, cmask, weights, seed)[0]


def attention_backward_reference(qkv_or_q, kv, key_mask, g_ctx, num_heads: int, causal: bool,
                                 seed=0, op_base=0, rate=0.0):
    """Plain version of the attention backward (``_attn_bwd_tile`` l.304),
    with the contract of ``_attn_bwd_call`` (l.730). Self (``kv`` None):
    qkv (B, S, 3H) -> dqkv (B, S, 3H). Cross: q (B, S, H), kv (B, S_k, 2H) ->
    (dq (B, S, H), dkv (B, S_k, 2H)). Outputs in the compute dtype."""
    cdtype = qkv_or_q.dtype
    if kv is None:
        H = qkv_or_q.shape[-1] // 3
        q, k, v = qkv_or_q[..., :H], qkv_or_q[..., H:2 * H], qkv_or_q[..., 2 * H:]
    else:
        H = qkv_or_q.shape[-1]
        q, k, v = qkv_or_q, kv[..., :H], kv[..., H:]
    b, sq, _ = q.shape
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
    dv = _merge(dv).to(cdtype)
    if kv is None:
        return torch.cat([dq, dk, dv], dim=-1)
    return dq, torch.cat([dk, dv], dim=-1)


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

    def ln_block(g_up, v, inv, gname, bname, op):
        yhat = _recover_yhat(v, W[gname], W[bname])
        dW[gname] = (g_up * yhat).sum(0)
        dW[bname] = g_up.sum(0)
        dr = _ln_bwd(g_up, yhat, inv, W[gname])
        k = keep(op)
        return dr, dr if k is None else dr * k

    # MLP block
    dr3, dy = ln_block(gy2, out.reshape(M, H), inv3, "g3", "be3", OP_MLP_OUT)
    dy_c = dy.to(cdtype)
    dW["w2"] = _mm_tn(R["m"], dy_c)
    dW["b2"] = dy.sum(0)
    du = _mm_nt(dy_c, W["w2"]) * gelu_grad(R["u"].float(), geom.gelu_exact)
    du_c = du.to(cdtype)
    xm = R["x2"] if geom.has_cross else R["x1"]
    dW["w1"] = _mm_tn(xm, du_c)
    dW["b1"] = du.sum(0)
    dxm = dr3 + _mm_nt(du_c, W["w1"])

    denc = None
    if geom.has_cross:
        sk = enc.shape[1]
        dr2, da2 = ln_block(dxm, R["x2"], inv2, "g2", "be2", OP_CROSS_OUT)
        da2_c = da2.to(cdtype)
        dW["wco"] = _mm_tn(R["ctx2"], da2_c)
        dW["bco"] = da2.sum(0)
        dctx2 = _mm_nt(da2_c, W["wco"]).to(cdtype)
        dqc, dkv = attention_backward_reference(
            R["qc"].view(b, s, H), R["kvc"].view(b, sk, 2 * H), cmask, dctx2.view(b, s, H), nh,
            False, seed, cross_op(nh), geom.attn_rate)
        dqc, dkv = dqc.reshape(M, H), dkv.reshape(b * sk, 2 * H)
        dW["wq"] = _mm_tn(R["x1"], dqc)
        dW["bq"] = dqc.float().sum(0)
        dW["wkv"] = _mm_tn(enc.reshape(b * sk, H), dkv)
        dW["bkv"] = dkv.float().sum(0)
        denc = _mm_nt(dkv, W["wkv"]).reshape(b, sk, H).to(enc_dtype or cdtype)
        dx1 = dr2 + _mm_nt(dqc, W["wq"])
    else:
        dx1 = dxm

    dr1, da1 = ln_block(dx1, R["x1"], inv1, "g1", "be1", OP_ATTN_OUT)
    da1_c = da1.to(cdtype)
    dW["wo"] = _mm_tn(R["ctx"], da1_c)
    dW["bo"] = da1.sum(0)
    dctx = _mm_nt(da1_c, W["wo"]).to(cdtype)
    dqkv = attention_backward_reference(R["qkv"].view(b, s, 3 * H), None, smask,
                                        dctx.view(b, s, H), nh, geom.causal, seed, 0,
                                        geom.attn_rate).reshape(M, 3 * H)
    dW["wqkv"] = _mm_tn(x2d, dqkv)
    dW["bqkv"] = dqkv.float().sum(0)
    dx = (dr1 + _mm_nt(dqkv, W["wqkv"])).reshape(b, s, H).to(cdtype)
    return dx, denc, tuple(dW[n].to(W[n].dtype) for n in _names(geom))


# ---------------------------------------------------------------- CUDA wrappers


_VP, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_FWD_ARGTYPES = [_VP] * 36 + [_I] * 9 + [_F, _U, _U, _F, _U, _F, _VP]


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


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
    if geom.head_dim > MAX_HEAD_DIM or H % 8 or geom.intermediate % 8:
        raise ValueError("the layer kernels need head_dim <= 128 and widths divisible by 8")
    _build.check_tensor("x", x, (b, s, H), torch.bfloat16, dev)
    names = _names(geom)
    if len(weights) != len(names):
        raise ValueError(f"expected {len(names)} weights ({names}), got {len(weights)}")
    W = dict(zip(names, weights))
    for n, shape in geom.weight_shapes().items():
        # matmul kernels in bf16; biases and LayerNorm parameters stay f32
        _build.check_tensor(n, W[n], shape, torch.bfloat16 if n.startswith("w") else torch.float32, dev)
    sk = s
    if geom.has_cross:
        if enc is None:
            raise ValueError("a decoder layer needs enc")
        sk = enc.shape[1]
        _build.check_tensor("enc", enc, (b, sk, H), torch.bfloat16, dev)
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
    W = dict(zip(_names(geom), weights))

    def ws(shape, dtype=torch.bfloat16):
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

    fn = _build.lib().kvq_bert_layer_fwd
    fn.argtypes = _FWD_ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):  # the library's runtime launches on the current device
        code = fn(
            _ptr(x), _ptr(enc), _ptr(smask), _ptr(cmask),
            *(_ptr(W.get(n)) for n in DEC_WEIGHTS),
            _ptr(qkv), _ptr(ctx), _ptr(ctx2), _ptr(acc), _ptr(x1), _ptr(qc), _ptr(kvc), _ptr(x2),
            _ptr(m), _ptr(u), _ptr(invs), _ptr(out),
            b, s, sk, geom.num_heads, geom.head_dim, F,
            int(geom.causal), int(geom.has_cross), int(geom.gelu_exact), geom.eps,
            seed_u32(seed or 0), keep_threshold(geom.attn_rate), keep_scale(geom.attn_rate),
            keep_threshold(geom.hid_rate), keep_scale(geom.hid_rate), _stream(dev),
        )
    _build.check(code, "kvq_bert_layer_fwd")
    fused_bert_layer.launches += 1
    fused_bert_layer.residual_launches += int(save)
    if not save:
        return out, None
    res = dict(qkv=qkv, ctx=ctx, x1=x1, qc=qc, kvc=kvc, ctx2=ctx2, x2=x2, u=u, m=m, invs=invs)
    return out, tuple(res[n] for n in residual_names(geom))


def layer_forward(geom: LayerGeom, x, enc, smask, cmask, weights, seed):
    """Training forward of one layer: ``(out, residuals)``, the residuals in
    :func:`residual_names` order. A CPU tensor takes
    :func:`layer_forward_reference`; a CUDA tensor launches
    ``csrc/layer_fwd.cu`` (bf16) or raises, adding one to
    ``fused_bert_layer.launches``."""
    _check_call(geom, seed)
    if x.device.type == "cpu":
        return layer_forward_reference(geom, x, enc, smask, cmask, weights, seed or 0)
    if x.device.type != "cuda":
        raise ValueError(f"layer_forward runs on CPU or CUDA tensors, got {x.device}")
    return _launch(geom, x, enc, smask, cmask, weights, seed, save=True)


def attention_backward(qkv_or_q, kv, key_mask, g_ctx, num_heads: int, causal: bool,
                       seed=0, op_base=0, rate=0.0):
    """The attention backward of the fused layer, self and cross, with the
    contract of :func:`attention_backward_reference`. Replaces the TPU
    kernels ``_attn_bwd_self_kernel`` / ``_attn_bwd_cross_kernel``
    (``layer_pallas.py:696/712``). A CPU tensor takes the plain version; a
    CUDA tensor launches ``csrc/layer_bwd.cu`` (bf16) or raises, and each
    launch adds one to ``attention_backward.launches`` (and, for
    cross-attention, to ``attention_backward.cross_launches``)."""
    if qkv_or_q.device.type == "cpu":
        return attention_backward_reference(qkv_or_q, kv, key_mask, g_ctx, num_heads, causal,
                                            seed, op_base, rate)
    if qkv_or_q.device.type != "cuda":
        raise ValueError(f"attention_backward runs on CPU or CUDA tensors, got {qkv_or_q.device}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    dev = qkv_or_q.device
    cross = kv is not None
    b, sq, w = qkv_or_q.shape
    H = w if cross else w // 3
    nh = num_heads
    sk = kv.shape[1] if cross else sq
    if H % nh or H // nh > MAX_HEAD_DIM or sq > MAX_SEQ or sk > MAX_SEQ or b == 0:
        raise ValueError(f"attention_backward takes head_dim <= {MAX_HEAD_DIM} and "
                         f"sequences of 1..{MAX_SEQ}")
    _build.check_tensor("qkv_or_q", qkv_or_q, (b, sq, w), torch.bfloat16, dev)
    _build.check_tensor("g_ctx", g_ctx, (b, sq, H), torch.bfloat16, dev)
    if cross:
        _build.check_tensor("kv", kv, (b, sk, 2 * H), torch.bfloat16, dev)
    if key_mask is not None:
        _build.check_tensor("key_mask", key_mask, (b, sk), torch.int32, dev)
    if cross:
        dq = torch.empty((b, sq, H), dtype=torch.bfloat16, device=dev)
        dkv = torch.empty((b, sk, 2 * H), dtype=torch.bfloat16, device=dev)
        q, q_ld, k, kv_ld = qkv_or_q, H, kv, 2 * H
        dq_ptr, dq_ld, dk_ptr, dkv_ld = dq.data_ptr(), H, dkv.data_ptr(), 2 * H
    else:
        dqkv = torch.empty((b, sq, 3 * H), dtype=torch.bfloat16, device=dev)
        q, q_ld, k, kv_ld = qkv_or_q, 3 * H, None, 3 * H
        dq_ptr, dq_ld, dk_ptr, dkv_ld = dqkv.data_ptr(), 3 * H, dqkv.data_ptr() + 2 * H, 3 * H
    k_ptr = k.data_ptr() if cross else q.data_ptr() + 2 * H  # bf16: 2 bytes per element
    fn = _build.lib().kvq_attention_bwd
    fn.argtypes = [_VP, _I, _VP, _VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _I] + [_I] * 6 + [_U, _U, _F, _I, _VP]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        code = fn(q.data_ptr(), q_ld, k_ptr, k_ptr + 2 * H, kv_ld, _ptr(key_mask),
                  g_ctx.data_ptr(), dq_ptr, dq_ld, dk_ptr, dk_ptr + 2 * H, dkv_ld,
                  b, nh, H // nh, sq, sk, int(causal),
                  seed_u32(seed), keep_threshold(rate), keep_scale(rate), op_base, _stream(dev))
    _build.check(code, "kvq_attention_bwd")
    attention_backward.launches += 1
    attention_backward.cross_launches += int(cross)
    return (dq, dkv) if cross else dqkv


attention_backward.launches = 0
attention_backward.cross_launches = 0  # the cross-attention share of ``launches``

# csrc/layer_bwd.cu entry points, with their ctypes signatures
_EPI = {"f32": 0, "bf16": 1, "add_f32": 4, "add_bf16": 5, "dgelu_erf": 6, "dgelu_tanh": 7}
_SIGS = {
    "kvq_gemm": [_I, _I, _VP, _I, _VP, _I, _VP, _I, _VP, _I, _VP, _I, _I, _I, _I, _I, _I, _VP,
                 _VP],
    "kvq_ln_bwd": [_VP, _I, _VP, _VP, _VP, _VP, _U, _U, _F, _U, _VP, _VP, _VP, _VP, _I, _I, _VP],
    "kvq_colsum": [_VP, _I, _I, _I, _I, _VP, _VP, _VP],
}
LN_BWD_ROWS = 32    # rows per block of csrc/layer_bwd.cu's LayerNorm backward (LNB_ROWS)
COLSUM_ROWS = 256   # rows per block of its column sums (CS_ROWS)


def _fn(name):
    fn = getattr(_build.lib(), name)
    fn.argtypes = _SIGS[name]
    fn.restype = ctypes.c_int
    return fn


class _Bwd:
    """Launches of ``csrc/layer_bwd.cu`` on one device and stream."""

    def __init__(self, dev):
        self.dev, self.st = dev, _stream(dev)

    def gemm(self, a, b, a_t: bool, b_t: bool, epi: str, out_dtype, aux=None, out2=False):
        """C = op(A) @ op(B) with the named epilogue; A^T / B^T read in place.
        Shapes: A (M, K) or, with a_t, (K, M); B (K, N) or, with b_t, (N, K)."""
        M = a.shape[1] if a_t else a.shape[0]
        K = a.shape[0] if a_t else a.shape[1]
        N = b.shape[0] if b_t else b.shape[1]
        c = torch.empty((M, N), dtype=out_dtype, device=self.dev)
        c2 = torch.empty((M, N), dtype=torch.float32, device=self.dev) if out2 else None
        splits, ws = 1, None
        if a_t:  # weight gradient: K is all rows; split it so the few output tiles fill the card
            tiles = -(-M // 128) * -(-N // 128)
            splits = max(1, min(16, -(-264 // tiles), K // 1024))
            if splits > 1:
                ws = torch.empty((splits, M, N), dtype=torch.float32, device=self.dev)
        code = _fn("kvq_gemm")(int(a_t), int(b_t), a.data_ptr(), a.shape[1], b.data_ptr(),
                               b.shape[1], c.data_ptr(), N, _ptr(c2), N, _ptr(aux),
                               0 if aux is None else aux.shape[1], M, N, K, _EPI[epi], splits,
                               _ptr(ws), self.st)
        _build.check(code, "kvq_gemm")
        return (c, c2) if out2 else c

    def ln(self, g_up, v, inv, gamma, beta, seed, op, rate, want_dr: bool):
        """LayerNorm backward: (dr f32 or None, da in bf16, dgamma, dbeta, dbias)."""
        M, N = v.shape
        dr = torch.empty((M, N), dtype=torch.float32, device=self.dev) if want_dr else None
        da = torch.empty((M, N), dtype=torch.bfloat16, device=self.dev)
        nparts = -(-M // LN_BWD_ROWS)
        parts = torch.empty((nparts, 3, N), dtype=torch.float32, device=self.dev)
        sums = torch.empty((3, N), dtype=torch.float32, device=self.dev)
        code = _fn("kvq_ln_bwd")(g_up.data_ptr(), int(g_up.dtype == torch.float32), v.data_ptr(),
                                 inv.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                 seed_u32(seed), keep_threshold(rate), keep_scale(rate), op,
                                 _ptr(dr), da.data_ptr(), parts.data_ptr(), sums.data_ptr(),
                                 M, N, self.st)
        _build.check(code, "kvq_ln_bwd")
        return dr, da, sums[0], sums[1], sums[2]

    def colsum(self, src):
        """f32 column sums of a (rows, N) bf16 or f32 matrix."""
        M, N = src.shape
        nparts = -(-M // COLSUM_ROWS)
        parts = torch.empty((nparts, N), dtype=torch.float32, device=self.dev)
        out = torch.empty((N,), dtype=torch.float32, device=self.dev)
        code = _fn("kvq_colsum")(src.data_ptr(), int(src.dtype == torch.float32), N, M, N,
                                 parts.data_ptr(), out.data_ptr(), self.st)
        _build.check(code, "kvq_colsum")
        return out


def _backward_launch(geom: LayerGeom, x, enc, smask, cmask, weights, seed, res, out, gy,
                     enc_dtype):
    """The kernel backward: the same sequence as :func:`layer_backward_reference`."""
    W = dict(zip(_names(geom), weights))
    R = dict(zip(residual_names(geom), res))
    dev, bf = x.device, torch.bfloat16
    b, s, H = x.shape
    M, nh = b * s, geom.num_heads
    inv1, inv2, inv3 = R["invs"]
    seed, hr = seed or 0, geom.hid_rate
    gy = gy.contiguous()
    if gy.dtype != bf or gy.shape != x.shape:
        raise TypeError(f"the layer's output gradient must be bf16 {tuple(x.shape)}")
    dW = {}
    with torch.cuda.device(dev):
        k = _Bwd(dev)
        # MLP block
        dr3, dy_c, dW["g3"], dW["be3"], dW["b2"] = k.ln(gy.view(M, H), out.view(M, H), inv3,
                                                        W["g3"], W["be3"], seed, OP_MLP_OUT, hr,
                                                        True)
        dW["w2"] = k.gemm(R["m"], dy_c, True, False, "bf16", bf)
        du_c, du = k.gemm(dy_c, W["w2"], False, True,
                          "dgelu_erf" if geom.gelu_exact else "dgelu_tanh", bf, aux=R["u"],
                          out2=True)
        dW["b1"] = k.colsum(du)
        del du
        xm = R["x2"] if geom.has_cross else R["x1"]
        dW["w1"] = k.gemm(xm, du_c, True, False, "bf16", bf)
        dxm = k.gemm(du_c, W["w1"], False, True, "add_f32", torch.float32, aux=dr3)
        del du_c, dr3
        denc = None
        if geom.has_cross:
            sk = enc.shape[1]
            dr2, da2_c, dW["g2"], dW["be2"], dW["bco"] = k.ln(dxm, R["x2"], inv2, W["g2"],
                                                              W["be2"], seed, OP_CROSS_OUT, hr,
                                                              True)
            dW["wco"] = k.gemm(R["ctx2"], da2_c, True, False, "bf16", bf)
            dctx2 = k.gemm(da2_c, W["wco"], False, True, "bf16", bf)
            dqc, dkv = attention_backward(R["qc"].view(b, s, H), R["kvc"].view(b, sk, 2 * H),
                                          cmask, dctx2.view(b, s, H), nh, False, seed,
                                          cross_op(nh), geom.attn_rate)
            dqc, dkv = dqc.view(M, H), dkv.view(b * sk, 2 * H)
            dW["wq"] = k.gemm(R["x1"], dqc, True, False, "bf16", bf)
            dW["bq"] = k.colsum(dqc)
            dW["wkv"] = k.gemm(enc.view(b * sk, H), dkv, True, False, "bf16", bf)
            dW["bkv"] = k.colsum(dkv)
            enc_out = torch.float32 if enc_dtype == torch.float32 else bf
            denc = k.gemm(dkv, W["wkv"], False, True, "f32" if enc_out == torch.float32 else "bf16",
                          enc_out).view(b, sk, H)
            dx1 = k.gemm(dqc, W["wq"], False, True, "add_f32", torch.float32, aux=dr2)
            del dr2
        else:
            dx1 = dxm
        # self-attention block
        dr1, da1_c, dW["g1"], dW["be1"], dW["bo"] = k.ln(dx1, R["x1"], inv1, W["g1"], W["be1"],
                                                         seed, OP_ATTN_OUT, hr, True)
        dW["wo"] = k.gemm(R["ctx"], da1_c, True, False, "bf16", bf)
        dctx = k.gemm(da1_c, W["wo"], False, True, "bf16", bf)
        dqkv = attention_backward(R["qkv"].view(b, s, 3 * H), None, smask, dctx.view(b, s, H),
                                  nh, geom.causal, seed, 0, geom.attn_rate).view(M, 3 * H)
        dW["wqkv"] = k.gemm(x.view(M, H), dqkv, True, False, "bf16", bf)
        dW["bqkv"] = k.colsum(dqkv)
        dx = k.gemm(dqkv, W["wqkv"], False, True, "add_bf16", bf, aux=dr1).view(b, s, H)
    layer_backward.launches += 1
    return dx, denc, tuple(dW[n] for n in _names(geom))


def layer_backward(geom: LayerGeom, x, enc, smask, cmask, weights, seed, res, out, gy,
                   enc_dtype=None):
    """Backward of one fused layer from its saved residuals: ``(dx, denc,
    dweights)``. Replaces the TPU kernel ``_layer_bwd_kernel``
    (``layer_pallas.py:552``). A CPU tensor takes
    :func:`layer_backward_reference`; a CUDA tensor runs ``csrc/layer_bwd.cu``
    (bf16) or raises, and each call adds one to ``layer_backward.launches``."""
    if x.device.type == "cpu":
        return layer_backward_reference(geom, x, enc, smask, cmask, weights, seed, res, out, gy,
                                        enc_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"layer_backward runs on CPU or CUDA tensors, got {x.device}")
    _check_layer_inputs(geom, x, enc, smask, cmask, weights)
    return _backward_launch(geom, x, enc, smask, cmask, weights, seed, res, out, gy, enc_dtype)


layer_backward.launches = 0


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
    Otherwise a CPU tensor, or ``reference=True``, goes through
    :func:`bert_layer_reference`, and a CUDA tensor launches
    ``csrc/layer_fwd.cu`` (bf16 only) on the current stream, or raises; each
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
    if reference or x.device.type == "cpu":
        return bert_layer_reference(geom, x, enc, smask, cmask, weights, seed or 0)
    return _launch(geom, x, enc, smask, cmask, weights, seed, save=False)[0]


fused_bert_layer.launches = 0
fused_bert_layer.residual_launches = 0  # of those, training launches that keep the residuals
