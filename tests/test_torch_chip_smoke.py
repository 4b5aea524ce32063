"""chip_smoke.py's arithmetic, on the CPU: the least work that its bounds
count for kernels B1 and B2 at the 2x chunk shape (B=4, H=16, t=128, T=256,
d=128, 10 relative-bias bases over a band of 128), against a count by hand,
and its tensor-core instruction counter against a short cuobjdump listing.
Meta tensors stand in for the inputs: only their shapes and types count."""

import pytest
import torch

import chip_smoke as cs

B, H, t, T, d, n, band = 4, 16, 128, 256, 128, 10, 128


def _inputs(dtype):
    meta = dict(device="meta")
    return (torch.empty((B, H, t, d), dtype=dtype, **meta), torch.empty((B, H, T, d), dtype=dtype, **meta),
            torch.empty((B, H, T, d), dtype=dtype, **meta), torch.empty((B, t, T), dtype=torch.bool, **meta),
            torch.empty((B, H, t, n), **meta), torch.empty((n, band), **meta))


def test_band_pairs_counts_the_band():
    # query i sees keys i + 1 .. i + 128 of the 256 (offset (T - t) + i - j in 0 .. 127)
    assert cs.band_pairs(t, T, band) == t * band
    assert cs.band_pairs(1, 1, 1) == 1
    assert cs.band_pairs(4, 4, 2) == 4 + 3


@pytest.mark.parametrize("dtype,elem", [(torch.float32, 4), (torch.bfloat16, 2)])
def test_b1_work_at_the_2x_chunk(dtype, elem):
    nbytes, products, bias = cs.b1_work(*_inputs(dtype))
    qkvo = (B * H * t * d * 2 + B * H * T * d * 2) * elem  # q and the output, k and v
    assert nbytes == qkvo + B * t * T + B * H * t * n * 4 + n * band * 4
    assert products == 2 * 2 * B * H * t * T * d == 1_073_741_824
    assert bias == 2 * B * H * (t * band) * n == 20_971_520


@pytest.mark.parametrize("dtype,elem", [(torch.float32, 4), (torch.bfloat16, 2)])
def test_b2_work_at_the_2x_chunk(dtype, elem):
    nbytes, products, bias = cs.b2_work(*_inputs(dtype))
    inputs = (B * H * t * d * 2 + B * H * T * d * 2) * elem + B * t * T + (B * H * t * n + n * band) * 4
    outputs = (B * H * t * d + B * H * T * d * 2) * elem + (B * H * t * n + n * band) * 4
    assert nbytes == inputs + outputs
    assert products == 5 * 2 * B * H * t * T * d == 2_684_354_560
    assert bias == 3 * 2 * B * H * (t * band) * n == 62_914_560


def test_bounds_take_the_tensor_core_rates():
    # B1 f32: 25.63 MB over 3.35 TB/s outweighs the products and the bias as three TF32 products at 495 TFLOP/s
    ms, by, nbytes, flops = cs.b1_bound(*_inputs(torch.float32))
    assert nbytes == 25_629_696 and flops == 1_073_741_824 + 20_971_520
    assert by == "bytes" and ms == pytest.approx(25_629_696 / 3.35e12 * 1e3)
    # B2 f32: the five products and the bias's three contractions (three TF32 products each) outweigh 46.93 MB
    ms, by, nbytes, _ = cs.b2_bound(*_inputs(torch.float32))
    assert nbytes == 46_934_016 and by == "operations"
    assert ms == pytest.approx(3 * (2_684_354_560 + 62_914_560) / 495e12 * 1e3)
    assert ms == pytest.approx(0.01665, abs=5e-6)
    # bf16: one product at 989 TFLOP/s each, the float32 bias as in f32; both are bound by their bytes
    for bound in (cs.b1_bound, cs.b2_bound):
        ms, by, nbytes, _ = bound(*_inputs(torch.bfloat16))
        assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_bias_is_priced_at_the_float32_tensor_core_rate_in_both_types():
    # R and b_nd are float32 whatever q's type: the bias takes three TF32 products even beside bf16 products
    for dtype in (torch.float32, torch.bfloat16):
        ms, by = cs.bound(0, 0, 165e9, dtype)  # 1 ms at 165 TFLOP/s
        assert by == "operations" and ms == pytest.approx(1.0)
    assert cs.bound(0, 989e9, 0, torch.bfloat16)[0] == pytest.approx(1.0)


def test_time_kernels_reports_what_the_comparison_reads(monkeypatch):
    """`--time-kernels` prints {"kernel_times": time_kernels(dev)}: B1 and B2
    in both types at the 2x chunk and at the IDM's and the PPO minibatch's
    shapes, each with the kernels line's timing keys.  Run on the CPU
    at a small shape, with one untimed call standing in for the CUDA events."""
    attention_inputs = cs.attention_inputs
    monkeypatch.setattr(cs, "attention_inputs",
                        lambda dev, B, H, t, maxlen, d, dtype, seed: attention_inputs(dev, 1, 2, 8, 8, 64, dtype, seed))
    monkeypatch.setattr(cs, "cuda_time_ms", lambda fn: (fn(), (1.0, True))[1])
    with torch.enable_grad():  # another module of the suite turns grad mode off when pytest imports it
        times = cs.time_kernels(torch.device("cpu"))
    labels = [""] + [f" {label}" for label in ("IDM window", "PPO minibatch")]
    assert set(times) == {f"{k} {t}{label}" for k in ("B1", "B2") for t in ("float32", "bfloat16") for label in labels}
    for row in times.values():
        assert set(row) == {"ms", "plain_ms", "library_ms", "bound_ms", "bound_by"}
        assert row["ms"] == row["plain_ms"] == row["library_ms"] == 1.0
        assert row["bound_ms"] > 0 and row["bound_by"] in ("bytes", "operations")


LISTING = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_129windowed_attention_fwd_kernelIfLi128ELi64EEEvPKT_
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0270*/                   HMMA.1688.F32.TF32 R24, R4, R20, R24 ;
        /*0280*/                   HMMA.16816.F32.BF16 R8, R12, R16, R8 ;
        /*0290*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
		..........
		Function : _ZN12_GLOBAL__N_116db_reduce_kernelEPKfPfii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   FADD R3, R2, R3 ;
		Function : _ZN12_GLOBAL__N_115bwd_rows_kernelIfLi128ELi64EEEvPKT_
        /*0000*/                   FFMA R3, R2, R3, R4 ;
"""


def test_sass_tensor_core_counts():
    counts = cs.sass_tensor_core_counts(LISTING)
    assert counts == {
        "_ZN12_GLOBAL__N_129windowed_attention_fwd_kernelIfLi128ELi64EEEvPKT_": 3,
        "_ZN12_GLOBAL__N_116db_reduce_kernelEPKfPfii": 0,
        "_ZN12_GLOBAL__N_115bwd_rows_kernelIfLi128ELi64EEEvPKT_": 0,
    }
    # the partial-sum reduction multiplies no matrices; a product kernel without HMMA fails
    assert cs.kernels_without_tensor_cores(counts) == ["_ZN12_GLOBAL__N_115bwd_rows_kernelIfLi128ELi64EEEvPKT_"]
    assert cs.kernels_without_tensor_cores({}) != []
    assert cs.kernels_without_tensor_cores({"k": 1, "db_reduce_kernel": 0}) == []


def test_b1_work_at_the_idm_labeling_shape_has_no_mask():
    """The IDM attends with no mask: no mask bytes, the band bias over 128 offsets."""
    Bi, Hi = 4, 32
    meta = dict(device="meta")
    q = torch.empty((Bi, Hi, t, d), **meta)
    kv = torch.empty((Bi, Hi, T, d), **meta)
    R, b_nd = torch.empty((Bi, Hi, t, n), **meta), torch.empty((n, band), **meta)
    nbytes, products, bias = cs.b1_work(q, kv, kv, None, R, b_nd)
    assert nbytes == (Bi * Hi * t * d * 2 + Bi * Hi * T * d * 2) * 4 + (Bi * Hi * t * n + n * band) * 4
    assert products == 2 * 2 * Bi * Hi * t * T * d and bias == 2 * Bi * Hi * t * band * n


def test_materialised_bias_without_mask_is_the_relative_bias():
    from vpt_tpu_torch.ops.rel_bias import relattn_bias

    g = torch.Generator().manual_seed(0)
    R, b_nd = torch.randn((2, 3, 4, n), generator=g), torch.randn((n, 4), generator=g)
    assert torch.equal(cs.materialised_bias(None, R, b_nd, 8, torch.float32), relattn_bias(R, b_nd, 8))
    mask = torch.rand((2, 4, 8), generator=g) < 0.5
    got = cs.materialised_bias(mask, R, b_nd, 8, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and bool((got[~mask[:, None].expand_as(got)] < -1e8).all())


@pytest.mark.parametrize("n_frames,window,stride,wb", [(20, 8, 4, 2), (16, 8, 8, 1), (5, 8, 4, 1), (21, 8, 4, 3)])
def test_owned_labels_rederive_the_streaming_labeler(n_frames, window, stride, wb):
    """Phase 8(b) holds the labeler against its own re-derivation of which
    window owns each frame; at a tiny IDM on the CPU the two agree."""
    import numpy as np

    from vpt_tpu_torch.agent import IDMAgent, StreamingIDMLabeler

    kwargs = dict(hidsize=32, impala_width=1, impala_chans=[4, 8], img_shape=[32, 32, 4],
                  init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1},
                  impala_kwargs={"post_pool_groups": 1}, n_recurrence_layers=1, timesteps=8, attention_heads=2,
                  attention_memory_size=16, recurrence_type="transformer", attention_mask_style="none",
                  conv3d_params={"inchan": 3, "outchan": 4, "kernel_size": [5, 1, 1], "padding": [2, 0, 0]},
                  use_pre_lstm_ln=False, obs_processing_width=16)
    agent = IDMAgent(kwargs, {}, device="cpu", seed=1)
    frames = np.random.default_rng(n_frames).integers(0, 256, (n_frames, 45, 80, 3), dtype=np.uint8)
    labeler = StreamingIDMLabeler(agent, window=window, stride=stride, window_batch=wb)
    labels = [x for f in frames for x in labeler.feed(f)] + labeler.finish()
    resized = np.stack([labeler._resize(f) for f in frames])
    direct = cs.owned_labels(agent, resized, window, stride, wb)
    assert [i for i, _ in direct] == [i for i, _ in labels] == list(range(n_frames))
    for (i, a), (_, b) in zip(labels, direct):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a), i
