"""Flash-attention forward: the CUDA kernel's wrapper and its plain twin.

Counterpart of ``repro/kernels/flash.py``. ``flash_attention`` checks its
inputs and calls the op ``repro_torch::flash_attention``
(``torch.library``, through ``build.define_op``), which launches the hand-written CUDA kernel
(``csrc/flash.cu``) on CUDA tensors and runs the plain PyTorch twin on CPU
tensors; on the meta device its fake gives the output's shape and computes
nothing (the dry run, ``launch/dryrun.py``); any other device raises. Its
FLOPs are registered with ``FlopCounterMode`` (``flash_flops``). The twin
follows the Pallas kernel ``_flash_kernel``: an online softmax over
(bq, bk) tiles with the state (m, l, acc) in float32, the same block-level
causal skip (a key tile runs iff ``k_start <= q_start + bq - 1``), the same
``-1e30`` mask and the same final ``acc / max(l, 1e-30)``. The CPU tests
hold it against ``repro`` (the Pallas kernel in interpret mode).

The bf16 kernel rounds one value more than the Pallas kernel does: its
PV product runs on the tensor cores, whose A operand is bf16, so each
probability p is rounded to bf16 before it multiplies V (the denominator l
sums the unrounded p). ``kernel_twin`` is the twin at the kernel's own
rounding points (its key tile width, and that rounding of p); the card
checks hold the kernel against it with the limit of ``bf16_error``, which
leaves room for nothing but accumulation order and one rounding of the
output, and against the Pallas-faithful twin with the looser 2e-2 of
``tests/test_flash_kernel.py``.

``flash_attention.launches`` counts the kernel's launches: one is added
where the kernel is launched and nowhere else (not by the twin or the
fake).

The layout is JAX's: q (B, S, H, dqk), k (B, T, KV, dqk) and v (B, T,
KV, dv) with H % KV == 0, output (B, S, H, dv) in v's dtype. S and T need
not be multiples of a tile (the Pallas kernel asserts it; neither the twin
nor the kernel needs it). dtypes: bfloat16 (the serving path's) and
float32; the widths (dqk, dv) one of ``HEAD_DIMS``: (dh, dh) for dh 16,
32, 64 or 128, and MLA's (192, 128) (deepseek-v3: q and k are 128 nope +
64 rope wide, v 128; ``repro`` computes that shape off the TPU through
``_flash_attn_pairs``, whose value width is v's own). ``ROUTES`` names
the kernel each (dtype, dqk, dv) reaches in ``csrc/flash.cu``: bf16 at
(64, 64), (128, 128) and (192, 128) (every served model) the Hopper
kernel (wgmma, TMA, a producer warpgroup), bf16 at (16, 16) and (32, 32)
the mma.sync kernel, float32 the FMA kernel.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

DEFAULT_BQ = 256  # the Pallas kernel's default tiles, which the twin uses
DEFAULT_BK = 512
# the (dqk, dv) pairs the kernel takes: one width for q, k and v, or MLA's
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128))
# flash.cu's route for each (dtype, dqk, dv) (its ROUTE lines in
# flash_attention_fwd) and each route's key tile width (kWgBk, kBk, kFk).
# The width sets the running max and so where each p is rounded:
# kernel_twin follows it.
ROUTES = {**{(torch.bfloat16, *dims): "wgmma" for dims in ((64, 64), (128, 128), (192, 128))},
          **{(torch.bfloat16, *dims): "mma.sync" for dims in ((16, 16), (32, 32))},
          **{(torch.float32, *dims): "fma" for dims in HEAD_DIMS}}
ROUTE_BK = {"wgmma": 128, "mma.sync": 64, "fma": 32}
KERNEL_BK = {key: ROUTE_BK[route] for key, route in ROUTES.items()}
# bf16_error's limits, as fractions of the output's scale (see there)
BF16_ULP_REL = 2.0 ** -7
BF16_ROW_FLOOR = 2.0 ** -6
BF16_MEAN_REL = 1e-3
NEG_INF = -1e30
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def flash_attention_twin(q, k, v, *, causal: bool = True, scale: float | None = None,
                         bq: int = DEFAULT_BQ, bk: int = DEFAULT_BK,
                         p_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of the kernel, tile by tile as ``_flash_kernel``;
    v may be narrower than q and k (MLA), the output is v's width.

    ``p_dtype`` rounds the probabilities to that dtype before PV (the
    denominator still sums them unrounded), as the bf16 kernel does; the
    default keeps them in float32, as ``_flash_kernel`` does."""
    B, S, H, dqk = q.shape
    T, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    rep = H // KV
    scale = dqk ** -0.5 if scale is None else scale
    bq, bk = min(bq, S), min(bk, T)
    qf = q.float().reshape(B, S, KV, rep, dqk)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, S, H, dv), dtype=v.dtype, device=q.device)
    for q_start in range(0, S, bq):
        qc = qf[:, q_start:q_start + bq]
        cq = qc.shape[1]
        qpos = torch.arange(q_start, q_start + cq, device=q.device)
        m = torch.full((B, KV, rep, cq), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, rep, cq), device=q.device)
        acc = torch.zeros((B, KV, rep, cq, dv), device=q.device)
        k_end = min(T, q_start + bq) if causal else T  # block-level causal skip
        for k_start in range(0, k_end, bk):
            kc, vc = kf[:, k_start:k_start + bk], vf[:, k_start:k_start + bk]
            s = torch.einsum("bqkrd,btkd->bkrqt", qc, kc) * scale
            if causal:
                kpos = torch.arange(k_start, k_start + kc.shape[1], device=q.device)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = p if p_dtype is None else p.to(p_dtype).float()
            acc = acc * corr[..., None] + torch.einsum("bkrqt,btkd->bkrqd", pv, vc)
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, q_start:q_start + cq] = o.permute(0, 3, 1, 2, 4).reshape(B, cq, H, dv).to(v.dtype)
    return out


def kernel_twin(q, k, v, *, causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """The twin at the CUDA kernel's own rounding points: key tiles as wide
    as those of the route the shape takes (so the running max, and with it
    each p, is the same) and, in bf16, p rounded to bf16 before PV. The
    query tile width and the causal skip change no value (a fully masked
    tile adds exact zeros)."""
    bf16 = q.dtype == torch.bfloat16
    return flash_attention_twin(q, k, v, causal=causal, scale=scale,
                                bk=KERNEL_BK[(q.dtype, q.shape[-1], v.shape[-1])],
                                p_dtype=torch.bfloat16 if bf16 else None)


def bf16_error(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How far the bf16 kernel's output ``got`` is from ``kernel_twin``'s
    ``want``, against the limit the card checks hold it to.

    The two differ only where a value rounded to bf16 lands on the other
    side of a midpoint, because the f32 values before the rounding differ
    by accumulation order. Rounding the output so costs one bf16 ulp, at
    most 2^-7 |want|. Rounding one p so moves that p by one bf16 ulp, at
    most 2^-7 p, and the output row by 2^-7 (p / l) |v| at most; with
    p / l no larger than the row's weights' norm and |v| within twice its
    rms, that is 2^-6 of the row's output rms. So, element by element,
    |got - want| <= 2^-7 |want| + 2^-6 rms_row(want), where rms_row is
    over the dv outputs of the element's (batch, position, head);
    and on average mean |got - want| <= 1e-3 rms(want).

    Returns ``max_abs``, ``limit_use`` (the largest |got - want| over its
    element's limit), ``floor_needed`` (the smallest factor in place of
    2^-6 that the element check would pass with), ``mean_rel``
    (mean |got - want| / rms(want)) and ``ok``."""
    w = want.float()
    d = (got.float() - w).abs()
    rms_row = w.square().mean(-1, keepdim=True).sqrt()
    ulp = BF16_ULP_REL * w.abs()
    tiny = torch.finfo(torch.float32).tiny
    use = float((d / (ulp + BF16_ROW_FLOOR * rms_row).clamp_min(tiny)).max())
    floor = float(((d - ulp).clamp_min(0) / rms_row.clamp_min(tiny)).max())
    rms = float(w.square().mean().sqrt())
    mean_rel = float(d.mean()) / max(rms, tiny)
    return dict(max_abs=float(d.max()), limit_use=use, floor_needed=floor, mean_rel=mean_rel,
                ok=use <= 1.0 and mean_rel <= BF16_MEAN_REL)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library, with its C signatures declared."""
    return declare(build.load("flash"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from ``csrc/flash.cu``."""
    lib.flash_attention_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                        ctypes.c_float, _I, _P]
    lib.flash_attention_fwd.restype = _I
    lib.flash_error_string.argtypes = [_I]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v) -> None:
    """Validate shapes, dtypes and devices."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention: want q (B, S, H, dqk), k (B, T, KV, dqk) and "
                         f"v (B, T, KV, dv), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, dqk = q.shape
    if k.shape[0] != B or k.shape[3] != dqk or k.shape[1] < 1 or H % k.shape[2]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(same B and dqk, T >= 1, H a multiple of KV)")
    if (dqk, v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {dqk} with value width {v.shape[3]}: "
                         f"(dqk, dv) not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one dtype of "
                        f"{list(_DTYPE_CODES)}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device) or q.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"flash_attention: q, k, v on {q.device}, {k.device}, {v.device} "
                         "(want one cuda, cpu or meta device)")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with the 16-byte alignment the kernel's vector loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Attention of q (B, S, H, dqk) over k (B, T, KV, dqk) and v (B, T,
    KV, dv), H % KV == 0. Returns (B, S, H, dv) in v's dtype. ``scale``
    defaults to dqk ** -0.5. The op ``repro_torch::flash_attention``: a
    CUDA tensor launches the kernel, a CPU tensor runs the twin, a meta
    tensor gets the output's shape only."""
    _check(q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _flash_op(q, k, v, bool(causal), float(scale))


def _flash(q, k, v, causal, scale):
    if q.device.type == "cpu":
        return flash_attention_twin(q, k, v, causal=causal, scale=scale)
    B, S, H, dqk = q.shape
    T, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((B, S, H, dv), dtype=v.dtype, device=q.device)
    if B * S == 0:
        return out
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T, H, KV, dqk, dv,
            _DTYPE_CODES[q.dtype], scale, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.flash_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} ({msg})")
    with _COUNT_LOCK:  # launches may come from several threads
        flash_attention.launches += 1
    return out


_flash_op = build.define_op(
    "flash_attention(Tensor q, Tensor k, Tensor v, bool causal, float scale) -> Tensor", _flash,
    lambda q, k, v, causal, scale: q.new_empty((*q.shape[:3], v.shape[3]), dtype=v.dtype))


def kept_pairs(S: int, T: int, causal: bool) -> int:
    """The (query, key) pairs the mask keeps: every pair, or causally
    query i (0-based) with keys 0..i, at most T of them."""
    if not causal:
        return S * T
    full = max(0, min(S, T))  # queries i < T keep i + 1 keys
    return full * (full + 1) // 2 + (S - full) * T


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flash_flops(q_shape, k_shape, v_shape, causal, scale, *, out_shape=None, **kwargs) -> int:
    """2 B H (dqk + dv) FLOPs a kept pair: its score and its share of PV."""
    B, S, H, dqk = q_shape
    return 2 * B * H * (dqk + v_shape[3]) * kept_pairs(S, k_shape[1], causal)


_COUNT_LOCK = threading.Lock()
flash_attention.launches = 0
