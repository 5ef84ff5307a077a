"""One post-LN BertLayer forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``kindergarten_vq_vae_tpu/ops/layer_pallas.py``
(``fused_bert_layer`` l.1129, ``_layer_fwd_core`` l.374). The kernel is
``csrc/layer_fwd.cu``; :func:`bert_layer_reference` is the same function in
plain PyTorch, at the same rounding points:

- matmul operands in the compute dtype, products accumulated in f32;
  biases and LayerNorm parameters f32;
- ``qkv``, ``qc``, ``kvc``, ``ctx``, ``x1``, ``x2`` and the GELU output
  rounded to the compute dtype; residual sums in f32;
- attention per sentence with a finite ``NEG_INF`` key / causal bias, softmax
  as ``e / z`` in f32, probabilities rounded before ``p @ v``;
- LayerNorm with flax's fast variance ``max(E[r^2] - mu^2, 0)``;
- exact GELU as ``0.5 u (1 + tanh(z p(z^2)))``, the ``_ERF_P`` polynomial.

Weights follow :data:`ENC_WEIGHTS` / :data:`DEC_WEIGHTS`, in the JAX
package's ``(in, out)`` layout, so the kernel reads row-major ``x @ W``
operands. Inference only: dropout and gradients come with the backward
kernel (ROADMAP, "TPU kernels", #2).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from kindergarten_vq_vae_torch import _build

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

# limits of csrc/layer_fwd.cu's attention kernel (ATT_MAX_S, ATT_MAX_HD)
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


# ---------------------------------------------------------------- plain version


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(rows, K) @ (K, N) with f32 accumulation; operands keep their values."""
    return a.float() @ w.float()


def _ln(r: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    mu = r.mean(-1, keepdim=True)
    var = torch.clamp((r * r).mean(-1, keepdim=True) - mu * mu, min=0.0)
    inv = torch.rsqrt(var + eps)
    return (r - mu) * inv * gamma + beta


def gelu(u: torch.Tensor, exact: bool) -> torch.Tensor:
    """f32 GELU as the kernel computes it (tanh-erf polynomial when exact)."""
    if exact:
        z = u / SQRT_2
        z2 = z * z
        acc = torch.full_like(z2, _ERF_P[-1])
        for c in _ERF_P[-2::-1]:
            acc = acc * z2 + c
        return 0.5 * u * (1.0 + torch.tanh(z * acc))
    w = TANH_C * (u + 0.044715 * u * u * u)
    return 0.5 * u * (1.0 + torch.tanh(w))


def _attention(q, k, v, key_mask, causal: bool, nh: int, hd: int) -> torch.Tensor:
    """Per-sentence attention. q (B, Sq, H), k/v (B, Sk, H) in the compute
    dtype; key_mask (B, Sk) or None. Returns the f32 context (B, Sq, H)."""
    b, sq, _ = q.shape
    sk = k.shape[1]
    qh = q.float().reshape(b, sq, nh, hd).transpose(1, 2)
    kh = k.float().reshape(b, sk, nh, hd).transpose(1, 2)
    vh = v.float().reshape(b, sk, nh, hd).transpose(1, 2)
    s = qh @ kh.transpose(-1, -2) * (1.0 / math.sqrt(hd))
    ok = torch.ones((b, 1, sq, sk), dtype=torch.bool, device=q.device)
    if key_mask is not None:
        ok = ok & (key_mask[:, None, None, :] > 0)
    if causal:
        ok = ok & torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril()
    s = s + torch.where(ok, 0.0, NEG_INF)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    ctx = p.to(q.dtype).float() @ vh
    return ctx.transpose(1, 2).reshape(b, sq, nh * hd)


def bert_layer_reference(geom: LayerGeom, x, enc, smask, cmask, weights) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same dtype, same rounding points).
    x (B, S, H) and enc (B, S_k, H) in the compute dtype; smask (B, S) and
    cmask (B, S_k) key-validity ints or None."""
    W = dict(zip(_names(geom), weights))
    cdtype = x.dtype
    b, s, H = x.shape
    x2d = x.reshape(b * s, H)

    qkv = (_mm(x2d, W["wqkv"]) + W["bqkv"]).to(cdtype).view(b, s, 3 * H)
    ctx = _attention(qkv[..., :H], qkv[..., H:2 * H], qkv[..., 2 * H:], smask, geom.causal,
                     geom.num_heads, geom.head_dim).to(cdtype)
    a1 = _mm(ctx.reshape(b * s, H), W["wo"]) + W["bo"]
    xm = _ln(x2d.float() + a1, W["g1"], W["be1"], geom.eps).to(cdtype)

    if geom.has_cross:
        sk = enc.shape[1]
        qc = (_mm(xm, W["wq"]) + W["bq"]).to(cdtype).view(b, s, H)
        kvc = (_mm(enc.reshape(b * sk, H), W["wkv"]) + W["bkv"]).to(cdtype).view(b, sk, 2 * H)
        ctx2 = _attention(qc, kvc[..., :H], kvc[..., H:], cmask, False,
                          geom.num_heads, geom.head_dim).to(cdtype)
        a2 = _mm(ctx2.reshape(b * s, H), W["wco"]) + W["bco"]
        xm = _ln(xm.float() + a2, W["g2"], W["be2"], geom.eps).to(cdtype)

    m = gelu(_mm(xm, W["w1"]) + W["b1"], geom.gelu_exact).to(cdtype)
    y = _mm(m, W["w2"]) + W["b2"]
    out = _ln(xm.float() + y, W["g3"], W["be3"], geom.eps).to(cdtype)
    return out.view(b, s, H)


# ---------------------------------------------------------------- CUDA wrapper


_VP = ctypes.c_void_p
_ARGTYPES = [_VP] * 33 + [ctypes.c_int] * 9 + [ctypes.c_float, _VP]


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _check_tensor(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype == torch.bfloat16 and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the GEMM loads 16-byte chunks)")


def _check_inference(geom: LayerGeom, tensors) -> None:
    if geom.attn_rate > 0.0 or geom.hid_rate > 0.0:
        raise NotImplementedError(
            "dropout inside the fused layer comes with its backward kernel "
            "(ROADMAP, TPU kernels: #2, with the hash dropout of #1)")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the fused layer is forward-only: its backward kernel is still to port "
            "(ROADMAP, TPU kernels: #2)")


def fused_bert_layer(geom: LayerGeom, x, enc, smask, cmask, weights) -> torch.Tensor:
    """One whole post-LN BERT layer. x (B, S, H); enc (B, S_k, H) or None;
    smask (B, S) / cmask (B, S_k) int32 key-validity masks or None (all
    valid); ``weights`` in ENC_WEIGHTS / DEC_WEIGHTS order.

    A CPU tensor goes through :func:`bert_layer_reference`. A CUDA tensor
    launches ``csrc/layer_fwd.cu`` (bf16 only) on the current stream, or
    raises; each launch adds one to ``fused_bert_layer.launches``."""
    weights = tuple(weights)
    _check_inference(geom, (x, enc, *weights))
    if x.device.type == "cpu":
        return bert_layer_reference(geom, x, enc, smask, cmask, weights)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bert_layer runs on CPU or CUDA tensors, got {x.device}")
    return _launch(geom, x, enc, smask, cmask, weights)


fused_bert_layer.launches = 0


def _launch(geom: LayerGeom, x, enc, smask, cmask, weights) -> torch.Tensor:
    dev = x.device
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, H), got {tuple(x.shape)}")
    b, s, H = x.shape
    if H != geom.hidden:
        raise ValueError(f"x width {H} != num_heads * head_dim = {geom.hidden}")
    if geom.head_dim > MAX_HEAD_DIM or H % 8 or geom.intermediate % 8:
        raise ValueError("the layer kernel needs head_dim <= 128 and widths divisible by 8")
    _check_tensor("x", x, (b, s, H), torch.bfloat16, dev)
    names = _names(geom)
    if len(weights) != len(names):
        raise ValueError(f"expected {len(names)} weights ({names}), got {len(weights)}")
    W = dict(zip(names, weights))
    for n, shape in geom.weight_shapes().items():
        # matmul kernels in bf16; biases and LayerNorm parameters stay f32
        _check_tensor(n, W[n], shape, torch.bfloat16 if n.startswith("w") else torch.float32, dev)
    sk = s
    if geom.has_cross:
        if enc is None:
            raise ValueError("a decoder layer needs enc")
        sk = enc.shape[1]
        _check_tensor("enc", enc, (b, sk, H), torch.bfloat16, dev)
    elif enc is not None:
        raise ValueError("enc given to a layer without cross-attention")
    if s > MAX_SEQ or sk > MAX_SEQ or s == 0 or b == 0:
        raise ValueError(f"sequence lengths must be in 1..{MAX_SEQ}, got {s} and {sk}")
    if smask is not None:
        _check_tensor("smask", smask, (b, s), torch.int32, dev)
    if cmask is not None:
        if not geom.has_cross:
            raise ValueError("cmask given to a layer without cross-attention")
        _check_tensor("cmask", cmask, (b, sk), torch.int32, dev)

    M, F = b * s, geom.intermediate

    def ws(shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device=dev)

    qkv, ctx, acc, x1, m, out = (ws((M, 3 * H)), ws((M, H)), ws((M, H), torch.float32),
                                 ws((M, H)), ws((M, F)), ws((b, s, H)))
    qc = kvc = x2 = None
    if geom.has_cross:
        qc, kvc, x2 = ws((M, H)), ws((b * sk, 2 * H)), ws((M, H))

    fn = _build.lib().kvq_bert_layer_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):  # the library's runtime launches on the current device
        code = fn(
            _ptr(x), _ptr(enc), _ptr(smask), _ptr(cmask),
            *(_ptr(W.get(n)) for n in DEC_WEIGHTS),
            _ptr(qkv), _ptr(ctx), _ptr(acc), _ptr(x1), _ptr(qc), _ptr(kvc), _ptr(x2), _ptr(m),
            _ptr(out), b, s, sk, geom.num_heads, geom.head_dim, F,
            int(geom.causal), int(geom.has_cross), int(geom.gelu_exact), geom.eps,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(code, "kvq_bert_layer_fwd")
    fused_bert_layer.launches += 1
    return out
