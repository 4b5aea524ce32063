"""The port's profiling taps (vpt_tpu_torch/utils/profiling.py) and its op
table tool (vpt_tpu_torch/tools/profile_ops.py), on the CPU:

  * ``activation_stats`` names and values equal to vpt_tpu's (rtol 1e-6) on
    a nested dict and list tree;
  * ``profile_trace`` writes a Chrome trace;
  * FLOP counts: the kernels' analytic count (``attention_flops``) equals
    what ``FlopCounterMode`` counts for the plain attention forward and
    backward, exactly, and the kernels' operators count it, so a step
    counts the same on the card (kernels) as here (plain); a tiny ``BCTrainer.train_step_flops`` (forward, backward,
    optimizer) is 2.5-3.5x ``compiled_flops`` of its forward (a backward
    does two products for each of the forward's) and leaves the trainer as
    it was; ``IDMTrainer.train_step_flops`` likewise;
  * the op table's categories and shares on canned kernel names, and its
    refusal of a trace without CUDA kernels."""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vpt_tpu.utils.profiling import activation_stats as jax_activation_stats
from vpt_tpu_torch.ops import windowed_attention as wa
from vpt_tpu_torch.tools import profile_ops
from vpt_tpu_torch.training import bc, idm
from vpt_tpu_torch.utils import profiling

TINY_KWARGS = dict(
    hidsize=64, impala_width=1, impala_chans=[4, 8], obs_processing_width=32, img_shape=[32, 32, 3],
    init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1}, impala_kwargs={"post_pool_groups": 1},
    recurrence_type="transformer", n_recurrence_layers=2, timesteps=4, attention_heads=4,
    attention_memory_size=8, use_pre_lstm_ln=False,
)


@pytest.fixture(autouse=True)
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


def test_activation_stats_match_vpt_tpu():
    rng = np.random.default_rng(0)
    tree = {"blocks": [{"k": rng.normal(size=(2, 3)), "v": rng.normal(size=(4,))}, rng.normal(size=(3, 3))],
            "a": rng.normal(size=(5,)), "nested": {"z": [rng.normal(size=(2,)), rng.normal(size=(2, 2))]}}
    to_torch = lambda t: ({k: to_torch(v) for k, v in t.items()} if isinstance(t, dict)  # noqa: E731
                          else [to_torch(v) for v in t] if isinstance(t, list)
                          else torch.from_numpy(t.astype(np.float32)))
    to_jax = lambda t: ({k: to_jax(v) for k, v in t.items()} if isinstance(t, dict)  # noqa: E731
                        else [to_jax(v) for v in t] if isinstance(t, list) else jnp.asarray(t, jnp.float32))
    got = profiling.activation_stats(to_torch(tree), prefix="pre/")
    expect = jax_activation_stats(to_jax(tree), prefix="pre/")
    assert list(got) == list(expect)
    assert "activation_mean/pre/blocks/[0]/k" in got and "activation_std/pre/nested/z/[1]" in got
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(expect[k]), rtol=1e-6, atol=1e-7)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(32, 32)
    with profiling.profile_trace(str(tmp_path)) as prof:
        (x @ x).sum()
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        assert json.load(f)["traceEvents"]
    assert any("mm" in e.name for e in prof.events())


@pytest.mark.parametrize("use_rel", [True, False])
def test_attention_flops_equal_the_counted_plain_attention(use_rel):
    g = torch.Generator().manual_seed(1)
    B, H, t, T, d = 2, 3, 5, 13, 16
    q, k, v = (torch.randn(s, generator=g, requires_grad=True) for s in ((B, H, t, d), (B, H, T, d), (B, H, T, d)))
    R = torch.randn((B, H, t, 10), generator=g, requires_grad=True) if use_rel else None
    b_nd = torch.randn((10, 8), generator=g, requires_grad=True) if use_rel else None
    mask = torch.rand((B, t, T), generator=g) < 0.7
    with FlopCounterMode(display=False) as fwd:
        out = wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, True)
    with FlopCounterMode(display=False) as bwd:
        out.sum().backward()
    assert (fwd.get_total_flops(), bwd.get_total_flops()) == wa.attention_flops(q, k, R, b_nd)


@pytest.mark.parametrize("use_rel", [True, False])
def test_compiled_flops_counts_the_kernels_operators(use_rel):
    """B1 and B2's operators count attention_flops under FlopCounterMode
    (meta tensors stand in for the card's here), beside aten's products."""
    B, H, t, T, d = 2, 3, 8, 24, 64
    meta = dict(device="meta")
    q, k, v = torch.empty((B, H, t, d), **meta), torch.empty((B, H, T, d), **meta), torch.empty((B, H, T, d), **meta)
    mask = torch.empty((B, t, T), dtype=torch.bool, **meta)
    R = torch.empty((B, H, t, 10), **meta) if use_rel else None
    b_nd = torch.empty((10, 16), **meta) if use_rel else None
    fwd, bwd = wa.attention_flops(q, k, R, b_nd)
    assert profiling.compiled_flops(lambda: torch.ops.vpt_torch.windowed_attention_fwd(
        q, k, v, mask, R, b_nd, True)) == fwd
    grads = []
    assert profiling.compiled_flops(lambda: grads.extend(torch.ops.vpt_torch.windowed_attention_bwd(
        q, k, v, mask, R, b_nd, q, True))) == bwd
    assert [tuple(g.shape) for g in grads[3:]] == ([(B, H, t, 10), (10, 16)] if use_rel else [(0,), (0,)])
    x = torch.randn(4, 8)
    assert profiling.compiled_flops(lambda: x @ x.T) == 2 * 4 * 8 * 4
    assert profiling.compiled_flops(lambda: x + 1) is None  # elementwise work counts nothing


def _bc_batch(B=2, T=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"frames": rng.integers(0, 256, (B, T, 32, 32, 3), dtype=np.uint8),
            "buttons": rng.integers(0, 8641, (B, T)), "camera": rng.integers(0, 121, (B, T)),
            "firsts": np.zeros((B, T), bool), "mask": np.ones((B, T), bool)}


def test_bc_train_step_flops_are_about_three_forwards():
    trainer = bc.BCTrainer(TINY_KWARGS, {"temperature": 2.0}, device="cpu", seed=0)
    trainer.init()
    batch = _bc_batch()
    before = {k: v.clone() for k, v in trainer.policy.state_dict().items()}
    step = trainer.train_step_flops(batch, trainer.initial_state(2))
    with torch.no_grad():
        forward = profiling.compiled_flops(trainer.masked_nll, trainer.to_device(batch), trainer.initial_state(2))
    assert step > 0 and 2.5 <= step / forward <= 3.5, (step, forward)
    assert trainer.step_count == 0 and not trainer.optimizer.adam.state
    for k, v in trainer.policy.state_dict().items():
        assert torch.equal(v, before[k]), k
    # the trainer then steps exactly as a fresh one does
    fresh = bc.BCTrainer(TINY_KWARGS, {"temperature": 2.0}, device="cpu", seed=0)
    losses = [t.train_step(batch, t.initial_state(2))[1].item() for t in (trainer, fresh)]
    assert losses[0] == losses[1]


def test_idm_train_step_flops():
    kwargs = dict(TINY_KWARGS, img_shape=[32, 32, 4], attention_mask_style="none",
                  conv3d_params={"inchan": 3, "outchan": 4, "kernel_size": [5, 1, 1], "padding": [2, 0, 0]})
    trainer = idm.IDMTrainer(kwargs, {}, hp=idm.IDMHyperparams(window=4), device="cpu", seed=0)
    batch = _bc_batch(seed=1)
    step = trainer.train_step_flops(batch)
    with torch.no_grad():
        forward = profiling.compiled_flops(trainer.masked_nll, trainer.to_device(batch))
    assert step > 0 and 2.5 <= step / forward <= 3.5, (step, forward)
    assert trainer.step_count == 0


@pytest.mark.parametrize("name,category", [
    ("void windowed_attention_fwd_kernel<float, 64>(float const*, ...)", "attention"),
    ("void bwd_keys_kernel<__nv_bfloat16, 128, 8>(...)", "attention"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc", "conv"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float, false, true>", "conv"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32", "gemm"),
    ("void pointwise_mult_and_sum_complex<float2, 8, 4>(float2*, float2*, float2*, int, int)", "conv"),
    ("void DSE::vector_fft<0, 1, 128, 8, 8, 1, float, float, float2>(float2*, float2*, int, int3, int3)", "conv"),
    ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn_n_tilesize64x64x8_stage3_execute_kernel__5x_cublas", "conv"),
    ("void at::native::(anonymous namespace)::ComputeInternalGradientsCUDAKernel<float>(long, ...)", "norm"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda(...)", "copy"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_16x6_tn_align4>(...)", "gemm"),
    ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float, float>(...)", "norm"),
    ("Memcpy HtoD (Pinned -> Device)", "copy"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>", "copy"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, ...>>", "reduction"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nchw<float, float>", "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>", "elementwise"),
    ("some_unknown_kernel", "other"),
])
def test_profile_ops_categories(name, category):
    assert profile_ops.category(name) == category


def test_profile_ops_table_and_refusal():
    rows = [{"op": "a", "category": "conv", "self_time_us": 30.0, "count": 3},
            {"op": "b", "category": "gemm", "self_time_us": 10.0, "count": 1}]
    table = profile_ops.summarize(rows, top=1)
    assert table["device_total_us"] == 40.0 and table["categories"] == {"conv": 0.75, "gemm": 0.25}
    assert [r["op"] for r in table["top_ops"]] == ["a"] and table["top_ops"][0]["self_time_share"] == 0.75
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.randn(8, 8).sum()
    assert profile_ops.kernel_rows(prof.events()) == []  # a host-only trace holds no kernel
    cuda = torch.autograd.DeviceType.CUDA
    events = [SimpleNamespace(name=n, device_type=d, time_range=SimpleNamespace(start=0.0, end=t), is_user_annotation=u)
              for n, d, t, u in (("k", cuda, 2.0, False), ("k", cuda, 3.0, False), ("Optimizer.step#Adam.step", cuda, 9.0, True),
                                 ("aten::mm", torch.autograd.DeviceType.CPU, 7.0, False))]
    assert profile_ops.kernel_rows(events) == [{"op": "k", "category": "other", "self_time_us": 5.0, "count": 2}]
    with pytest.raises(RuntimeError, match="no CUDA kernel events"):
        profile_ops.summarize([], top=5)
