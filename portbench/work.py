"""The yardstick's arithmetic: model FLOPs from a configuration's shapes,
the least work of the attention kernels B1 and B2, and the peaks of one
NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the 700 W limit).

Model FLOPs count the matrix products and convolutions the published graph
needs (2 per multiply-add), whatever executes them: a recompute under remat
is not counted, and norms, activations and softmax are not counted.  A
training step counts 3 forwards (forward, and a backward of twice its
FLOPs).  Attention counts every (query, key) pair of its window, as the
kernels' bound below does.
"""

from __future__ import annotations

from typing import Optional, Sequence

from portbench.reference.model import NBASIS, Arch

HBM_BYTES_PER_S = 3.35e12
TENSOR_FLOPS = {"float32": 495e12, "bfloat16": 989e12}  # TF32 for float32 (see mfu's note in PERF.md)
# a product at the accuracy of its input type: float32 as three TF32 products
PRODUCT_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "bool": 1}


def _conv(cin: int, cout: int, k: int, h: int, w: int) -> float:
    return 2.0 * cin * cout * k * h * w


def cnn_flops(arch: Arch) -> float:
    """FLOPs of one frame through the conv3d front (the IDM's), the Impala
    stacks and the dense layer to 256."""
    h, w = arch.img
    flops, c = 0.0, arch.in_chans
    if arch.idm:
        kt, kh, kw = arch.conv3d["kernel_size"]
        out = int(arch.conv3d["outchan"])
        flops += _conv(c, out, kt * kh * kw, h, w)
        c = out
    for out in arch.chans:
        flops += _conv(c, out, 9, h, w)
        h, w = (h + 1) // 2, (w + 1) // 2
        flops += 2 * arch.nblock * _conv(out, out, 9, h, w)
        c = out
    return flops + 2.0 * arch.cnn_out * arch.dense_out


def block_flops(arch: Arch, keys: int) -> float:
    """FLOPs of one frame through one residual block attending over ``keys``
    keys: q, k, v, proj, the relative-bias coefficients, QKᵀ and W·V, the
    bias on the band, and the MLP."""
    e = arch.hidsize
    dense = 2.0 * e * e * (4 + 2 * arch.pointwise_ratio) + 2.0 * e * NBASIS * arch.heads
    attention = 2 * 2.0 * keys * e
    bias = 2.0 * arch.heads * min(keys, arch.maxlen) * NBASIS
    return dense + attention + bias


def forward_flops_per_frame(arch: Arch, keys: int) -> float:
    """Model FLOPs of one frame's forward, its attention over ``keys`` keys
    (the chunk's steps plus ``maxlen`` cached ones; ``maxlen`` at t = 1 on
    the ring cache)."""
    e = arch.hidsize
    flops = cnn_flops(arch) + 2.0 * arch.dense_out * e
    flops += arch.n_blocks * block_flops(arch, keys)
    flops += 2.0 * e * e  # lastlayer (the IDM computes it and discards it)
    flops += 2.0 * e * sum(v * c for _, (v, c) in arch.head_shapes)
    if arch.value_head:
        flops += 2.0 * e
    return flops


def train_flops_per_frame(arch: Arch, chunk: int) -> float:
    return 3.0 * forward_flops_per_frame(arch, chunk + arch.maxlen)


def band_pairs(t: int, T: int, bandsize: int) -> int:
    """(query, key) pairs on the relative-bias band of a (t, T) grid."""
    return sum(max(0, min(T, i + T - t + 1) - max(0, i + T - t - bandsize + 1)) for i in range(t))


def _nbytes(shape: Optional[Sequence[int]], dtype: str) -> int:
    if not shape:
        return 0
    n = 1
    for s in shape:
        n *= int(s)
    return n * DTYPE_BYTES[dtype]


def least_ms(nbytes: float, products: float, bias: float, dtype: str) -> float:
    """The larger of the bytes at HBM bandwidth and the products at the
    input type's tensor-core rate plus the float32 bias FLOPs."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = products / PRODUCT_FLOPS[dtype] + bias / PRODUCT_FLOPS["float32"]
    return max(t_bytes, t_ops) * 1e3


def b1_least_ms(q, k, mask, R, b_nd, dtype: str) -> float:
    """Least time of one B1 call from its input shapes: q, k, v read once,
    the output written once (v and the output are q's and k's sizes), the
    mask (bool), R and b_nd (float32) read once; QKᵀ and W·V over every
    pair; n FMAs a pair on the band."""
    B, H, t, d = q
    T = k[2]
    nbytes = 2 * _nbytes(q, dtype) + 2 * _nbytes(k, dtype) + _nbytes(mask, "bool")
    nbytes += _nbytes(R, "float32") + _nbytes(b_nd, "float32")
    bias = 2.0 * B * H * band_pairs(t, T, b_nd[1]) * R[-1] if R else 0.0
    return least_ms(nbytes, 4.0 * B * H * t * T * d, bias, dtype)


def b2_least_ms(q, k, mask, R, b_nd, dtype: str) -> float:
    """Least time of one B2 call: inputs q, k, v, dO, mask, R, b_nd read once,
    dq, dk, dv, dR, d b_nd written once; five t×T×d products; the bias
    recompute, dR and d b_nd, n FMAs a pair each on the band."""
    B, H, t, d = q
    T = k[2]
    nbytes = 3 * _nbytes(q, dtype) + 4 * _nbytes(k, dtype) + _nbytes(mask, "bool")
    nbytes += 2 * (_nbytes(R, "float32") + _nbytes(b_nd, "float32"))
    bias = 3 * 2.0 * B * H * band_pairs(t, T, b_nd[1]) * R[-1] if R else 0.0
    return least_ms(nbytes, 10.0 * B * H * t * T * d, bias, dtype)
