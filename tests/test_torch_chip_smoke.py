"""chip_smoke.py's arithmetic, on the CPU: the least work that its bounds
count for kernels B1 and B2 at the 2x chunk shape (B=4, H=16, t=128, T=256,
d=128, 10 relative-bias bases over a band of 128), against a count by hand,
and its tensor-core instruction counter against a short cuobjdump listing.
Meta tensors stand in for the inputs: only their shapes and types count."""

import pytest
import torch

import chip_smoke as cs

B, H, t, T, d, n, band = 4, 16, 128, 256, 128, 10, 128


@pytest.fixture(autouse=True)
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


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
    in both types at the 2x chunk and at the IDM's, the PPO minibatch's and
    the 3x chunk's shapes, and C1 in float32 at the 13 convolutions of
    C1_SHAPES, each with the kernels line's timing keys.  Run on the CPU
    at a small shape, with one untimed call standing in for the CUDA events."""
    attention_inputs, conv_inputs = cs.attention_inputs, cs.conv_inputs
    monkeypatch.setattr(cs, "attention_inputs",
                        lambda dev, B, H, t, maxlen, d, dtype, seed: attention_inputs(dev, 1, 2, 8, 8, 64, dtype, seed))
    monkeypatch.setattr(cs, "conv_inputs", lambda dev, n, c, k, hw, seed: conv_inputs(dev, 1, 8, 8, 4, seed))
    monkeypatch.setattr(cs, "cuda_time_ms", lambda fn, iters=20: (fn(), (1.0, True))[1])
    with torch.enable_grad():  # another module of the suite turns grad mode off when pytest imports it
        times = cs.time_kernels(torch.device("cpu"))
    labels = [""] + [f" {label}" for label in ("IDM window", "PPO minibatch", "3x chunk")]
    assert len(cs.C1_SHAPES) == 13
    assert set(times) == ({f"{k} {t}{label}" for k in ("B1", "B2") for t in ("float32", "bfloat16") for label in labels}
                          | {f"C1 float32 {shape[0]}" for shape in cs.C1_SHAPES})
    for row in times.values():
        assert set(row) == {"ms", "plain_ms", "library_ms", "bound_ms", "bound_by"}
        assert row["ms"] == row["plain_ms"] == row["library_ms"] == 1.0
        assert row["bound_ms"] > 0 and row["bound_by"] in ("bytes", "operations")



def test_c1_work_reads_each_tensor_once_and_counts_the_products():
    x, w = cs.conv_inputs(torch.device("cpu"), 2, 8, 16, 4, 0)
    nbytes, flops = cs.c1_work(x, w)
    assert nbytes == 4 * (2 * 8 * 16 + 16 * 8 * 9 + 2 * 16 * 16)
    assert flops == 2 * 2 * 16 * 8 * 9 * 16
    # f32 products at three TF32 products' rate: at the IDM's first conv they, not the bytes, bound C1
    assert cs.bound(nbytes, flops, 0, torch.float32) == (pytest.approx(nbytes / 3.35e12 * 1e3), "bytes")
    idm = dict(zip(("n", "c", "k", "hw"), cs.C1_SHAPES[0][1:]))
    x = torch.empty((idm["n"], idm["c"], idm["hw"], idm["hw"]), device="meta")
    w = torch.empty((idm["k"], idm["c"], 3, 3), device="meta")
    nbytes, flops = cs.c1_work(x, w)
    assert cs.bound(nbytes, flops, 0, torch.float32) == (pytest.approx(flops / (495e12 / 3) * 1e3), "operations")

def _c1_phase(monkeypatch, kernel):
    """Phase 17 on the CPU at a small shape: `kernel` in C1's place, one
    untimed call standing in for the CUDA events."""
    from vpt_tpu_torch.ops import conv

    conv_inputs = cs.conv_inputs
    monkeypatch.setattr(cs, "conv_inputs", lambda dev, n, c, k, hw, seed: conv_inputs(dev, 2, 8, 8, 4, seed))
    monkeypatch.setattr(cs, "cuda_time_ms", lambda fn, iters=20: (fn(), (1.0, True))[1])
    monkeypatch.setattr(cs, "release_memory", lambda: None)
    monkeypatch.setattr(conv, "conv3x3_fwd", kernel)
    return cs.check_c1(torch.device("cpu"))


def _launching(fn):
    from vpt_tpu_torch.ops import conv

    def kernel(x, w, b=None, relu=True):
        conv.launches += 1
        return fn(x, w, b, relu)
    return kernel


def test_c1_phase_checks_every_shape_and_reports_its_kernels_entry(monkeypatch):
    from vpt_tpu_torch.ops import conv

    entry = _c1_phase(monkeypatch, _launching(conv.conv3x3_fwd_plain))
    assert entry["name"] == "conv3x3_fwd" and entry["source"] == "vpt_tpu_torch/csrc/conv3x3_fwd.cu"
    labels = {shape[0] for shape in cs.C1_SHAPES}
    assert set(entry["checked"]) == set(entry["shapes"]) == labels
    assert entry["max_rel_gap"] == 0.0
    assert entry["launches"] == {"bc_step": 14, "bc_remat_step": 224, "idm_labeling_forward": 15,
                                 "idm_train_step": 15, "idm_remat_step": 240, "bf16_labeling_forward": 0}
    for row in entry["shapes"].values():
        assert set(row) == set(cs.TIME_KEYS)


@pytest.mark.parametrize("fault", ["tf32_error", "no_launch"])
def test_c1_phase_fails_a_wrong_kernel(monkeypatch, fault):
    """A result off by one TF32 rounding of the output, or a call that
    launches nothing (the conv left to cuDNN), fails phase 17."""
    from vpt_tpu_torch.ops import conv

    if fault == "tf32_error":
        kernel = _launching(lambda x, w, b, relu: conv.conv3x3_fwd_plain(x, w, b, relu) * (1 + 2.0 ** -11))
    else:
        kernel = conv.conv3x3_fwd_plain
    with pytest.raises(AssertionError):
        _c1_phase(monkeypatch, kernel)


def test_c1_launch_counts_must_match():
    cs.check_c1_launches("BC train", 70, 5 * cs.C1_POLICY_CONVS)
    with pytest.raises(AssertionError, match="C1 launched 0 times, expected 70"):
        cs.check_c1_launches("BC train", 0, 5 * cs.C1_POLICY_CONVS)


def test_c1s_weight_split_multiplies_no_matrices():
    """C1's pass that splits the weights into TF32 halves runs no tensor-core
    instruction, as B2's partial-sum reduction; its product kernel must."""
    counts = {"_ZN12_GLOBAL__N_120split_weights_kernelEPKfPfiiiil": 0,
              "_ZN12_GLOBAL__N_118conv3x3_fwd_kernelILi128ELi1EEEvPKfS2_S2_PfNS_8GeometryEi": 0}
    assert cs.kernels_without_tensor_cores(counts) == [
        "_ZN12_GLOBAL__N_118conv3x3_fwd_kernelILi128ELi1EEEvPKfS2_S2_PfNS_8GeometryEi"]
    assert "conv3x3_fwd" in cs.KERNELS


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


def test_ptxas_spills_names_the_functions_that_spill():
    log = """ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'
ptxas info    : Function properties for _Z1av
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'
ptxas info    : Function properties for _Z1bv
    40 bytes stack frame, 40 bytes spill stores, 56 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 40 bytes cumulative stack size
"""
    assert cs.ptxas_spills(log) == {"_Z1bv": (40, 56)}
    assert cs.ptxas_spills("") == {}
    assert len(cs.demangled(["_Z1bv"])) == 1


def test_reset_launch_counts_zeroes_both_kernels_counts():
    """Every main path reads B1's and B2's launches from zero."""
    from vpt_tpu_torch.ops import windowed_attention as wa

    counts = (wa.launches, wa.bwd_launches)
    try:
        wa.launches, wa.bwd_launches = 3, 4
        cs.reset_launch_counts()
        assert (wa.launches, wa.bwd_launches) == (0, 0)
    finally:
        wa.launches, wa.bwd_launches = counts


def test_numpy_resize_is_the_agents_host_preparation():
    """Phase 4's numpy run prepares the same frames as the native pool."""
    import numpy as np

    from vpt_tpu_torch.agent import MineRLAgent

    kwargs = dict(hidsize=64, impala_chans=[4, 8], img_shape=[32, 32, 3], n_recurrence_layers=1, timesteps=4,
                  attention_heads=4, attention_memory_size=8, recurrence_type="transformer")
    agent = MineRLAgent(device="cpu", policy_kwargs=kwargs, batch_size=3)
    obs = [{"pov": np.random.default_rng(i).integers(0, 256, (36, 64, 3), dtype=np.uint8)} for i in range(3)]
    np.testing.assert_array_equal(cs.numpy_resize(agent)(obs), agent._env_obs_to_agent(obs))


TINY_POLICY = dict(hidsize=64, impala_chans=[4, 8], img_shape=[32, 32, 3], n_recurrence_layers=1, timesteps=4,
                   attention_heads=4, attention_memory_size=8, recurrence_type="transformer")


def test_phase_11_int8_weight_and_product_checks():
    """Phase 11(a)'s checks pass on a quantized twin of a float model and
    catch one flipped code; the products compare by layer name."""
    from vpt_tpu_torch.agent import MineRLAgent

    f = MineRLAgent(device="cpu", policy_kwargs=TINY_POLICY, batch_size=2)
    q = MineRLAgent(device="cpu", policy_kwargs=TINY_POLICY, batch_size=2, quantize_dense=True)
    # the CNN's projection, q/k/v/proj/r and the two MLP layers of the one block, lastlayer
    assert cs.quant_layers(q.policy) == 9 and cs.quant_layers(f.policy) == 0
    bad, n = cs.quantized_weights_match_cpu(f.policy, q.policy)
    assert bad == [] and n == 2 * cs.quant_layers(q.policy)
    q.policy.net.lastlayer.layer.weight_q8[0, 0] += 1
    assert cs.quantized_weights_match_cpu(f.policy, q.policy)[0] == ["net.lastlayer.layer.weight_q8"]
    products = cs.int8_products_match_cpu(q.policy, torch.device("cpu"), (2, 20))
    assert [p[0] for p in products[::2]] == ["orc_block.q_layer", "orc_block.r_layer", "mlp0.layer", "mlp1.layer"]
    assert all(exact and err == 0.0 for *_, exact, err in products)


def test_counted_int_mm_counts_and_restores():
    real = torch._int_mm
    a, b = torch.ones((17, 8), dtype=torch.int8), torch.ones((8, 8), dtype=torch.int8)
    with cs.CountedIntMM() as mm:
        torch._int_mm(a, b)
        torch._int_mm(a, b)
    assert mm.calls == [False, False] and torch._int_mm is real  # CPU tensors count as not on CUDA


def test_resume_within_spread_holds_the_resumed_run_to_the_spread(monkeypatch):
    """Phase 12's rule: with deterministic algorithms on, the uninterrupted
    step 3s agree bit for bit (their spread is 0), the fresh trainer's state
    equals the saved one bit for bit, and its step 3 equals theirs bit for
    bit; the earlier setting comes back after."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    seen = []

    def check(noise, resumed_gap, restored_state=1.0):
        runs = iter(noise)

        def step3(fresh):
            seen.append(torch.are_deterministic_algorithms_enabled())
            x = resumed_gap if fresh is not None else next(runs)
            return 1.0 + x, {"w": torch.tensor([x])}

        state_of = lambda t: {"w": torch.tensor([1.0 if t is None else restored_state])}  # noqa: E731
        return cs.resume_within_spread("toy", state_of, lambda s: None, lambda p: None, lambda p: "fresh", step3)

    assert cs.RESUME_RUNS == 4
    was = torch.are_deterministic_algorithms_enabled()
    assert check([0.0] * 4, 0.0) == (0, 0)
    assert seen == [True] * 5 and torch.are_deterministic_algorithms_enabled() == was
    with pytest.raises(AssertionError, match="not deterministic"):
        check([0.0, 1e-3, 2e-4, 5e-4], 1.5e-3)
    with pytest.raises(AssertionError, match="not deterministic"):
        check([0.0, 0.0, 0.0, 1e-9], 0.0)
    with pytest.raises(AssertionError, match="differs from the uninterrupted"):
        check([0.0] * 4, 1e-7)
    with pytest.raises(AssertionError, match="differs at"):
        check([0.0] * 4, 0.0, restored_state=2.0)
    assert torch.are_deterministic_algorithms_enabled() == was


def test_trainer_state_and_load_put_a_trainer_back():
    from vpt_tpu_torch.training.bc import BCTrainer

    trainer = BCTrainer(TINY_POLICY, {}, device="cpu")
    trainer.init()
    snap = cs.trainer_state(trainer, [{"k": torch.ones(2)}])
    batch = cs.bc_batch(torch.device("cpu"), 1, 4, 32, 0)
    trainer.train_step(batch, trainer.initial_state(1))
    assert trainer.step_count == 1 and cs.max_param_gap(snap["policy"], trainer.policy.state_dict()) > 0
    assert "/step_count" in cs.differing(cs.trainer_state(trainer, [{"k": torch.ones(2)}]), snap)
    cs.trainer_load(trainer, snap)
    assert cs.differing(cs.trainer_state(trainer, [{"k": torch.ones(2)}]), snap) == []
    assert cs.differing(cs.trainer_state(trainer, [{"k": torch.zeros(2)}]), snap) == ["/carried/0/k"]


def test_dir_bytes_counts_every_file(tmp_path):
    (tmp_path / "a").write_bytes(b"12345")
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "b").write_bytes(b"123")
    assert cs.dir_bytes(tmp_path) == 8


def test_relu_decisions_replay_the_recorded_side():
    """Phases 7(a), 8(a), 9(a) and 11(c)/(d): the CPU's step replays the
    card's dense ReLU decisions.  On identical models replaying changes
    nothing; on a perturbed one its layers pass exactly where the recorded
    side passed, and the flips are counted."""
    from vpt_tpu_torch.training.bc import BCTrainer

    a, b = (BCTrainer(TINY_POLICY, {}, device="cpu", seed=0) for _ in range(2))
    a.init()
    b.init()
    batch = cs.bc_batch(torch.device("cpu"), 2, 4, 32, 0)
    relus = cs.ReluDecisions()
    with relus.record(a.policy):
        _, loss_a, _ = a.train_step(batch, a.initial_state(2))
    with relus.replay(b.policy):
        _, loss_b, _ = b.train_step(batch, b.initial_state(2))
    assert relus.flipped == 0 and relus.total == 2 * 4 * (64 * 4 + 64 + 64)  # mlp0, the CNN's projection, lastlayer
    assert loss_a == loss_b and cs.max_param_gap(a.policy.state_dict(), b.policy.state_dict()) == 0

    with torch.no_grad():
        b.policy.net.recurrent_layer.blocks[0].mlp0.layer.weight.add_(
            1e-2 * torch.randn_like(b.policy.net.recurrent_layer.blocks[0].mlp0.layer.weight))
    relus, passed = cs.ReluDecisions(), []
    with relus.record(a.policy):
        a.masked_nll(a.to_device(batch), a.initial_state(2))
    mlp0 = b.policy.net.recurrent_layer.blocks[0].mlp0
    with relus.replay(b.policy):
        hook = mlp0.register_forward_hook(lambda m, args, out: passed.append(out != 0))  # runs after the replay's
        try:
            b.masked_nll(b.to_device(batch), b.initial_state(2))
        finally:
            hook.remove()
    assert relus.flipped > 0
    assert torch.equal(passed[0], relus.masks[1])  # the CNN's projection's decisions first, then this mlp0's
    with pytest.raises(AssertionError, match="fewer dense ReLUs"):
        with relus.replay(b.policy):
            pass


# ------------------------------------------------------------------ phase 13

def test_strided_bounds_count_the_attended_pairs():
    """Phase 13(b) prices strided attention over the pairs its mask lets
    attend: stride 2, maxlen 128 at t=128, T=256 leaves query i the keys of
    its own phase back to offset min(254, 128 + i)."""
    from vpt_tpu_torch.ops.strided_attention import strided_mask

    mask = strided_mask(t, T, 2, 128)[None].expand(B, t, T)
    per_query = [min(128, (128 + i) // 2 + 1) for i in range(t)]
    pairs = cs.attended_pairs(mask, H)
    assert pairs == B * H * sum(per_query)
    q, k, v, _, _, _ = _inputs(torch.float32)
    nbytes, products, bias = cs.b1_work(q, k, v, mask, None, None, pairs)
    assert products == 2 * 2 * pairs * d and bias == 0
    assert cs.b2_work(q, k, v, mask, None, None, pairs)[1] == 5 * 2 * pairs * d
    assert cs.b1_work(q, k, v, mask, None, None)[1] == 2 * 2 * B * H * t * T * d  # dense where no pairs are given
    assert cs.attended_pairs(strided_mask(t, T, 4, 64)[None].expand(B, t, T), H) < pairs


def test_materialised_bias_without_relative_bias_is_the_mask():
    mask = torch.rand((2, 3, 5), generator=torch.Generator().manual_seed(0)) < 0.5
    bias = cs.materialised_bias(mask, None, None, 5, torch.float32)
    assert bias.shape == (2, 1, 3, 5)
    assert torch.equal(bias[:, 0] == 0, mask) and torch.all(bias[:, 0][~mask] == -1e9)


def test_phase_13_helpers():
    from vpt_tpu_torch.config import FOUNDATION_POLICY_KWARGS

    kw = cs.variant_kwargs(recurrence_type="multi_masked_lstm")
    assert kw["recurrence_type"] == "multi_masked_lstm" and kw["hidsize"] == FOUNDATION_POLICY_KWARGS["hidsize"]
    assert FOUNDATION_POLICY_KWARGS["recurrence_type"] == "transformer"
    errs = cs.max_errors({"a": torch.tensor([1.0, 2.5])}, {"a": torch.tensor([1.0, 2.0])})
    assert errs == {"a": 0.5}
    out = {"pi_logits": {"buttons": torch.zeros(1)}, "vpred": torch.ones(1), "vpred_raw": torch.ones(1)}
    assert sorted(cs.policy_outputs(out)) == ["buttons", "vpred"]
    policy = torch.nn.Module()
    policy.conv = torch.nn.Module()
    policy.conv.norm = torch.nn.Module()
    policy.conv.norm.register_buffer("running_mean", torch.zeros(2))
    policy.conv.norm.register_buffer("running_var", torch.ones(2))
    policy.normalizer = torch.nn.Module()
    policy.normalizer.register_buffer("running_mean", torch.zeros(1))  # the value head's EWMA, not batch norm
    assert sorted(cs.batch_norm_stats(policy)) == ["conv.norm.running_mean", "conv.norm.running_var"]


def test_streamed_smem_holds_the_launches_to_one_size(monkeypatch):
    """Phase 16's read of the streamed instance's shared memory passes where
    the launches take the same bytes at d = 320 and 4096, in both types, and
    fails where any depends on d (a stand-in for the card's query)."""
    from vpt_tpu_torch.ops import windowed_attention as wa

    same = {"B1": 90000, "B2 pass 1": 91000, "B2 pass 2": 120000}
    monkeypatch.setattr(wa, "launch_smem_bytes", lambda T, d, nbasis, bandsize, dtype: dict(same))
    assert cs.streamed_smem(256, 128) == {"float32": same, "bfloat16": same}
    monkeypatch.setattr(wa, "launch_smem_bytes",
                        lambda T, d, nbasis, bandsize, dtype: dict(same, **{"B2 pass 2": 120000 + d}))
    with pytest.raises(AssertionError, match="depends on d"):
        cs.streamed_smem(256, 128)
