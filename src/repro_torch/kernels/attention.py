"""Flash attention: causal, sliding-window or non-causal, fp32 online softmax
(port of ``repro.kernels.attention``).

``flash_attention`` is the public function in the reference's (H, S, hd)
layout; ``attention`` is the same computation in the model's GQA layout,
q (B, S, H, hd) against k, v (B, S, KV, hd), which the LM's prefill calls.
Both are wrappers around three hand-written CUDA kernels in
``csrc/attention.cu``, which replace the Pallas kernel
``repro/kernels/attention.py::_flash_kernel``; ``kernel_for`` picks one by
type and head_dim, and nothing falls back from one to another:

- ``flash_attention_wgmma_kernel`` (bf16 at head_dim 32, 64, 128 and 320):
  the tensor cores through ``wgmma``, K and V loaded by TMA into a ring of
  shared-memory stages, one producer warp and two consumer warpgroups;
  p.V runs as two bf16 products, ``p_hi = bf16(p)`` and
  ``p_lo = bf16(p - p_hi)``, into one fp32 accumulator. Its key tile
  depends on head_dim (``WGMMA_KERNEL_KEYS``).
- ``flash_attention_tf32_kernel`` (fp32 at head_dim 64, 128 and 320): the
  same design on TF32 tiles; every fp32 operand of q.k^T and p.V is split
  in two TF32 parts (``split_tf32``) and each product is formed as three
  TF32 products, hi.hi + hi.lo + lo.hi (3xTF32). Key tile:
  ``TF32_KERNEL_KEYS``. At head_dim 320 its two consumer warpgroups split
  head_dim, and s is the sum of their two halves (``TF32_SPLIT_HEAD_DIMS``).
- ``flash_attention_kernel`` (fp32 at head_dim 32): fp32 products on the
  CUDA cores.

For tensors on the CPU they run the plain PyTorch version beside them,
which has the chosen kernel's dataflow: a running max, normalizer and
accumulator in fp32, folded over the kernel's key tiles, with p split in
two bf16 parts where the wgmma kernel splits it and both products split
in TF32 parts where the tf32 kernel splits them. Any other device raises.

The kernels' tiles are fixed; ``bq``/``bk`` and ``kv_block`` set the plain
version's key blocks only. Block sizes change where the online softmax
rounds, not what it computes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG = -1e30
#: head_dims the kernel is instantiated for: 32 (the smoke configs), 64,
#: 128 and 320 (gemma3-4b's 2560 / 8).
HEAD_DIMS = (32, 64, 128, 320)
#: Keys per tile of ``flash_attention_kernel``; the plain version with this
#: block folds the online softmax at the same keys.
KERNEL_KEYS = 64
#: Keys per tile of ``flash_attention_wgmma_kernel``'s instance, by
#: head_dim (bf16 only): 128 at 128 (qwen3, llama3, starcoder2, qwen2-vl,
#: mixtral) and 64 (musicgen, granite, hymba, fourierpim-lm); 48 at 320
#: (gemma3-4b), where 128 query rows a CTA split between the two consumer
#: warpgroups, a 64 x 320 fp32 accumulator and the 227 KB of shared memory
#: leave room for no larger tile; 128 at 32 (every reduced config), by an
#: A/B of tiles on the card (PERF.md).
WGMMA_KERNEL_KEYS = {32: 128, 64: 128, 128: 128, 320: 48}
WGMMA_HEAD_DIMS = tuple(WGMMA_KERNEL_KEYS)
#: Keys per tile of ``flash_attention_tf32_kernel``'s instance, by head_dim
#: (fp32 only): 32 at 128, where Q_lo and two stages of K_hi, K_lo, V,
#: V^T_hi and V^T_lo fill 224 KB of shared memory; 64 at 64; 8 at 320
#: (gemma3-4b), where 64 query rows a CTA, Q_lo and three stages of K_hi,
#: K_lo, V^T_hi and V^T_lo fill 209 KB.
TF32_KERNEL_KEYS = {64: 64, 128: 32, 320: 8}
TF32_HEAD_DIMS = tuple(TF32_KERNEL_KEYS)
#: head_dims at which the tf32 kernel's two consumer warpgroups split
#: head_dim in halves, each forming s over its own: s is half 0 + half 1,
#: and the plain version sums it so.
TF32_SPLIT_HEAD_DIMS = (320,)
#: kernel -> its C launcher, whose name is also its launch counter
LAUNCHERS = {"wgmma": "flash_attention_wgmma", "tf32": "flash_attention_tf32",
             "cuda_core": "flash_attention"}
_TYPES = (torch.float32, torch.bfloat16)


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel serves (dtype, head_dim): ``"wgmma"`` for bf16 at
    head_dim 32, 64, 128 or 320, ``"tf32"`` for fp32 at head_dim 64, 128
    or 320, else ``"cuda_core"`` (fp32 at 32). The wrappers and the plain
    version both follow it."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    if dtype == torch.float32 and head_dim in TF32_HEAD_DIMS:
        return "tf32"
    return "cuda_core"


def kernel_keys(dtype: torch.dtype, head_dim: int,
                kernel: str | None = None) -> int:
    """Keys per tile of ``kernel`` (default: the one ``kernel_for``
    picks)."""
    kernel = kernel or kernel_for(dtype, head_dim)
    if kernel == "wgmma":
        return WGMMA_KERNEL_KEYS[head_dim]
    if kernel == "tf32":
        return TF32_KERNEL_KEYS[head_dim]
    return KERNEL_KEYS


def split_bf16(p: torch.Tensor) -> torch.Tensor:
    """fp32 p as the wgmma kernel feeds it to the tensor cores: p_hi + p_lo
    with p_hi = bf16(p) and p_lo = bf16(p - p_hi), summed in fp32 (exact:
    together they hold about 16 significant bits)."""
    hi = p.to(torch.bfloat16).float()
    return hi + (p - hi).to(torch.bfloat16).float()


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 (10 fraction bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does: add half of the 13 dropped
    bits to the magnitude's bit pattern and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 x as the tf32 kernel feeds it to the tensor cores: x_hi =
    tf32(x) and x_lo = tf32(x - x_hi) (the subtraction is exact in fp32).
    Together they hold about 22 significant bits: |x - x_hi - x_lo| <=
    2^-22 |x|."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _product_3xtf32(eq: str, a: torch.Tensor, b: torch.Tensor
                    ) -> torch.Tensor:
    """einsum(eq, a, b) as the tf32 kernel forms it: a_hi.b_hi + a_hi.b_lo
    + a_lo.b_hi, the lo.lo term dropped."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return (torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, al, bh))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, causal: bool = True, scale: float,
                    kv_block: int | None = None,
                    kernel: str | None = None) -> torch.Tensor:
    """Plain version of ``attention``: the online softmax of ``kernel``
    (``"wgmma"``, ``"tf32"`` or ``"cuda_core"``; default: the one
    ``kernel_for`` picks), over key blocks of ``kv_block`` (default: that
    kernel's key tile), as torch ops, in the layout of
    ``repro.models.layers.attention.blockwise_attention``. For the wgmma
    kernel, p enters the p.V product as ``split_bf16(p)``; for the tf32
    kernel, q.k^T and p.V are each three TF32 products
    (``_product_3xtf32``), and at ``TF32_SPLIT_HEAD_DIMS`` q.k^T is summed
    over the two halves of head_dim, as the kernel's two warpgroups sum
    it.

    q: (B, S, H, hd); k, v: (B, S, KV, hd), H = KV * G, head h = kv * G + g.
    Returns (B, S, H, hd) in q's type; s = (q . k) * scale in fp32.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    kernel = kernel or kernel_for(q.dtype, hd)
    product = _product_3xtf32 if kernel == "tf32" else torch.einsum
    scores = product
    if kernel == "tf32" and hd in TF32_SPLIT_HEAD_DIMS:
        def scores(eq, a, b):
            h = hd // 2
            return (product(eq, a[..., :h], b[..., :h])
                    + product(eq, a[..., h:], b[..., h:]))
    if kv_block is None:
        kv_block = kernel_keys(q.dtype, hd, kernel)
    qh = q.reshape(B, S, KV, G, hd).float()
    blk = max(1, min(kv_block, S))
    qpos = torch.arange(S, device=q.device)
    m = torch.full((B, KV, G, S), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, S, hd), dtype=torch.float32,
                      device=q.device)
    for j0 in range(0, S, blk):
        kj = k[:, j0:j0 + blk].float()
        vj = v[:, j0:j0 + blk].float()
        s = scores("bqkgh,bnkh->bkgqn", qh, kj) * scale
        kpos = j0 + torch.arange(kj.shape[1], device=q.device)
        # the last block is cut at S, so every key here has kpos < S
        valid = torch.ones((S, kj.shape[1]), dtype=torch.bool,
                           device=q.device)
        if causal:
            valid = (kpos[None, :] <= qpos[:, None]) \
                & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(valid, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        if kernel == "wgmma":
            p = split_bf16(p)
        acc = acc * corr[..., None] + product("bkgqn,bnkh->bkgqh", p, vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    # (B, KV, G, S, hd) -> (B, S, KV, G, hd) -> (B, S, H, hd); h = kv*G + g
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    B, S, H, hd = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[:2] != (B, S) \
            or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"attention: q {tuple(q.shape)} against k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: expected "
                         f"(B, S, H, hd) and (B, S, KV, hd) with KV | H")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _TYPES:
        raise TypeError(f"attention takes float32 or bfloat16 q, k, v of one "
                        f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"attention: tensors on {q.device}, {k.device} and "
                         f"{v.device}")
    if window < 1:
        raise ValueError(f"attention: window={window}, need >= 1")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            window: int, causal: bool, scale: float) -> torch.Tensor:
    """Launch the kernel that ``kernel_for`` picks on (B, S, H, hd) views
    with any strides whose head_dim axis is contiguous; returns a
    contiguous (B, S, H, hd) o."""
    B, S, H, hd = q.shape
    kernel = kernel_for(q.dtype, hd)
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head_dim {hd} is not "
                         f"one of {HEAD_DIMS}")
    # flash_attention_kernel loads 4 elements at a time; TMA (the wgmma and
    # tf32 kernels) takes a base on 16 bytes and strides of 16 bytes: 8
    # bf16 or 4 fp32 elements
    step = 8 if kernel == "wgmma" else 4
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash attention kernel: {name}'s head_dim "
                             f"axis must be contiguous, strides "
                             f"{t.stride()}")
        if t.data_ptr() % 16 or any(t.stride(i) % step for i in range(3)):
            raise ValueError(f"flash attention kernel: {name} must start on "
                             f"16 bytes with strides that are multiples of "
                             f"{step} elements, got strides {t.stride()}")
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if B == 0 or S == 0:
        return o
    name = LAUNCHERS[kernel]
    with torch.cuda.device(q.device):
        _build.launch(
            name, name, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), B, S, H, k.shape[2], hd, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            min(int(window), 1 << 30), int(causal), float(scale),
            int(q.dtype == torch.bfloat16))
    return o


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int, causal: bool = True, scale: float,
              kv_block: int | None = None) -> torch.Tensor:
    """Attention in the model's GQA layout: q (B, S, H, hd), k, v
    (B, S, KV, hd); returns (B, S, H, hd) in q's type. ``scale`` multiplies
    the fp32 scores (the model passes 1.0 after scaling q itself).

    On the card: one launch of the kernel ``kernel_for`` picks, no copies
    of q, k or v. On the CPU: ``attention_plain`` with key blocks of
    ``kv_block`` (default: that kernel's key tile); on the ``meta`` device
    the same ops, which compute nothing (the dry-run counts their
    products).
    """
    _check(q, k, v, window)
    if q.device.type in ("cpu", "meta"):
        return attention_plain(q, k, v, window=window, causal=causal,
                               scale=scale, kv_block=kv_block)
    if q.device.type != "cuda":
        raise ValueError(f"attention: no kernel for device {q.device}")
    _build.refuse_grad("attention", q, k, v)
    return _launch(q, k, v, window=window, causal=causal, scale=scale)


def _heads_as_batch(x: torch.Tensor) -> torch.Tensor:
    """(H, S, hd) -> a (1, S, H, hd) view."""
    if x.ndim != 3:
        raise ValueError(f"flash_attention takes (H, S, hd), got "
                         f"{tuple(x.shape)}")
    return x.permute(1, 0, 2)[None]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, window: int = 1 << 30, causal: bool = True,
                          bq: int = 128, bk: int = 128) -> torch.Tensor:
    """Plain version of ``flash_attention`` (key blocks of min(bk, S);
    ``bq`` does not change the result)."""
    del bq
    out = attention_plain(*(_heads_as_batch(x) for x in (q, k, v)),
                          window=window, causal=causal,
                          scale=q.shape[-1] ** -0.5, kv_block=bk)
    return out[0].permute(1, 0, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 1 << 30, causal: bool = True,
                    bq: int = 128, bk: int = 128) -> torch.Tensor:
    """q, k, v: (H, S, hd) (fold batch and GQA groups into H upstream), fp32
    or bf16. Returns (H, S, hd) in q's type; s = (q . k) * hd^-0.5 in fp32.

    On the card: the kernel ``kernel_for`` picks, through strided views,
    with its own tiles. On the CPU: ``flash_attention_plain``. Replaces
    ``repro/kernels/attention.py::flash_attention``.
    """
    q4, k4, v4 = (_heads_as_batch(x) for x in (q, k, v))
    _check(q4, k4, v4, window)
    if q.device.type in ("cpu", "meta"):
        return flash_attention_plain(q, k, v, window=window, causal=causal,
                                     bq=bq, bk=bk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _build.refuse_grad("flash_attention", q, k, v)
    out = _launch(q4, k4, v4, window=window, causal=causal,
                  scale=q.shape[-1] ** -0.5)
    return out[0].permute(1, 0, 2)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 1 << 30, causal: bool = True) -> torch.Tensor:
    """Naive oracle in the (H, S, hd) layout: the full score matrix, masked
    softmax."""
    H, S, hd = q.shape
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * hd ** -0.5
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    valid = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        valid = (kpos <= qpos) & (kpos > qpos - window)
    s = torch.where(valid[None], s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v.float()).to(q.dtype)
