"""Flash attention: causal, sliding-window or non-causal, fp32 online softmax
(port of ``repro.kernels.attention``).

``flash_attention`` is the public function in the reference's (H, S, hd)
layout; ``attention`` is the same computation in the model's GQA layout,
q (B, S, H, hd) against k, v (B, S, KV, hd), which the LM's prefill calls.
Both are wrappers: for tensors on the card they launch the hand-written
CUDA kernel ``flash_attention_kernel`` (``csrc/attention.cu``), which
replaces the Pallas kernel ``repro/kernels/attention.py::_flash_kernel``;
for tensors on the CPU they run the plain PyTorch version beside it, which
has the kernel's dataflow: a running max, normalizer and accumulator in
fp32, folded over key blocks. Any other device raises.

The kernel's tiles are fixed (64 query rows, 64 keys); ``bq``/``bk`` and
``kv_block`` set the plain version's key blocks only. Block sizes change
where the online softmax rounds, not what it computes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG = -1e30
#: head_dims the kernel is instantiated for: 32 (the smoke configs), 64,
#: 128 and 320 (gemma3-4b's 2560 / 8).
HEAD_DIMS = (32, 64, 128, 320)
#: Keys per tile of the kernel; the plain version with this block folds the
#: online softmax at the same keys.
KERNEL_KEYS = 64
_TYPES = (torch.float32, torch.bfloat16)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, causal: bool = True, scale: float,
                    kv_block: int = KERNEL_KEYS) -> torch.Tensor:
    """Plain version of ``attention``: the kernel's online softmax over key
    blocks of ``kv_block``, as torch ops, in the layout of
    ``repro.models.layers.attention.blockwise_attention``.

    q: (B, S, H, hd); k, v: (B, S, KV, hd), H = KV * G, head h = kv * G + g.
    Returns (B, S, H, hd) in q's type; s = (q . k) * scale in fp32.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
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
        s = torch.einsum("bqkgh,bnkh->bkgqn", qh, kj) * scale
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
        acc = acc * corr[..., None] + torch.einsum("bkgqn,bnkh->bkgqh", p, vj)
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
    """Launch ``flash_attention_kernel`` on (B, S, H, hd) views with any
    strides whose head_dim axis is contiguous; returns a contiguous
    (B, S, H, hd) o."""
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head_dim {hd} is not "
                         f"one of {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash attention kernel: {name}'s head_dim "
                             f"axis must be contiguous, strides "
                             f"{t.stride()}")
        # the kernel loads 4 elements at a time, so rows start aligned
        if t.data_ptr() % 16 or any(t.stride(i) % 4 for i in range(3)):
            raise ValueError(f"flash attention kernel: {name} must start on "
                             f"16 bytes with strides that are multiples of "
                             f"4 elements, got strides {t.stride()}")
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if B == 0 or S == 0:
        return o
    with torch.cuda.device(q.device):
        _build.launch(
            "flash_attention", "flash_attention", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), B, S, H, k.shape[2], hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], min(int(window), 1 << 30), int(causal),
            float(scale), int(q.dtype == torch.bfloat16))
    return o


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int, causal: bool = True, scale: float,
              kv_block: int = KERNEL_KEYS) -> torch.Tensor:
    """Attention in the model's GQA layout: q (B, S, H, hd), k, v
    (B, S, KV, hd); returns (B, S, H, hd) in q's type. ``scale`` multiplies
    the fp32 scores (the model passes 1.0 after scaling q itself).

    On the card: kernel ``flash_attention_kernel``, one launch, no copies of
    q, k or v. On the CPU: ``attention_plain`` with key blocks of
    ``kv_block``.
    """
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, window=window, causal=causal,
                               scale=scale, kv_block=kv_block)
    if q.device.type != "cuda":
        raise ValueError(f"attention: no kernel for device {q.device}")
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

    On the card: kernel ``flash_attention_kernel`` through strided views,
    with its own tiles. On the CPU: ``flash_attention_plain``. Replaces
    ``repro/kernels/attention.py::flash_attention``.
    """
    q4, k4, v4 = (_heads_as_batch(x) for x in (q, k, v))
    _check(q4, k4, v4, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window, causal=causal,
                                     bq=bq, bk=bk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
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
