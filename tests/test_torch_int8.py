"""The port's int8 serving and QAT (vpt_tpu_torch/ops/int8.py and its
callers) against vpt_tpu's, at tiny configs on the CPU, on weights carried
by ``from_jax_variables`` and inputs from a numpy seed.

Held exactly: weight codes and scales (``quantize_kernel``), activation
codes and scales (``dynamic_quantize_rows``), fake-quantized weights and
their identity gradient, the QAT mask key for key, and the quantized
agents' int8 weights against vpt_tpu's quantized variable trees.
``int8_matmul`` and ``QuantLinear`` rtol 1e-6 (the int32 products are
exact; the dequantization is the same three float32 operations).

The whole quantized model is held less tightly: per-row activation
quantization is discontinuous, so one float32 ulp of difference upstream
(the CNN, a LayerNorm: sums in another order in the two frameworks) can
move a code by one and that row's output by a full step.  The tests count
the activation codes that differ between port and vpt_tpu at every int8
layer's input: each differs by at most one, at most ``CODE_FLIP_SHARE`` of
them, and the logits (log-probabilities) are held at ``QUANT_LOGIT_TOL``,
the value at ``QUANT_VALUE_TOL``; with no code differing, to 2e-3 as the
float models.  A QAT train step's loss equals the plain step's on
fake-quantized weights to rtol 1e-6 and vpt_tpu's QAT loss to the port's BC
parity tolerance (rtol 1e-5).
"""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.ops import int8 as jax_int8
from vpt_tpu_torch.checkpoint import from_jax_variables
from vpt_tpu_torch.checkpoint.torch_import import torch_key
from vpt_tpu_torch.ops import int8

CODE_FLIP_SHARE = 1e-3   # activation codes that may differ by one between port and vpt_tpu
QUANT_LOGIT_TOL = 5e-2   # log-probabilities, where a code differs
QUANT_VALUE_TOL = 1e-3   # value estimate, where a code differs
FLOAT_TOL = 2e-3         # as the float models' parity (tests/test_torch_policy.py)


@pytest.fixture(autouse=True)
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


def _weight(shape, seed, zero_col=False):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if zero_col:
        w[:, 1] = 0.0  # an all-zero output channel: scale 1e-12, codes 0
    return w


@pytest.mark.parametrize("shape,zero_col", [((64, 32), False), ((48, 24), True), ((7, 160), False)])
def test_quantize_kernel_codes_and_scales_equal(shape, zero_col):
    w = _weight(shape, shape[0], zero_col)  # JAX layout (in, out)
    jq, js = jax_int8.quantize_kernel(jnp.asarray(w))
    q, s = int8.quantize_kernel(torch.from_numpy(w.T.copy()))  # torch layout (out, in)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy().T, np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dynamic_quantize_rows_equal(dtype):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(6, 16)) * rng.uniform(0.01, 100, size=(6, 1))).astype(np.float32)
    x[2] = 0.0  # a zero row quantizes to codes 0
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jax_int8.dynamic_quantize_rows(jx)
    q, s = int8.dynamic_quantize_rows(tx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


@pytest.mark.parametrize("rows", [1, 8, 40])
def test_int8_matmul_matches_vpt_tpu(rows):
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(rows, 128)).astype(np.float32)
    w = rng.normal(size=(128, 64)).astype(np.float32)
    jq, js = jax_int8.quantize_kernel(jnp.asarray(w))
    want = np.asarray(jax_int8.int8_matmul(jnp.asarray(x), jq, js))
    got = int8.int8_matmul(torch.from_numpy(x), torch.from_numpy(np.asarray(jq).T.copy()),
                           torch.from_numpy(np.asarray(js))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    rel = np.linalg.norm(got - x @ w) / np.linalg.norm(x @ w)
    assert rel < 0.02, rel  # and close to the float product


def test_int8_product_refuses_unaligned_shapes_on_cuda():
    """K and N must be multiples of 8 for torch._int_mm; checked before the
    device is touched, so the CPU can see the refusal."""
    with pytest.raises(ValueError, match="multiples of 8"):
        int8._check_int_mm(36, 64)
    with pytest.raises(ValueError, match="multiples of 8"):
        int8._check_int_mm(64, 20)


def test_fake_quant_kernel_values_and_straight_through_gradient():
    w = _weight((48, 24), 7)
    want = np.asarray(jax_int8.fake_quant_kernel(jnp.asarray(w)))
    tw = torch.from_numpy(w.T.copy()).requires_grad_(True)
    fq = int8.fake_quant_kernel(tw)
    np.testing.assert_array_equal(fq.detach().numpy().T, want)
    q, s = int8.quantize_kernel(tw.detach())
    np.testing.assert_array_equal(fq.detach().numpy(), q.float().numpy() * s.numpy()[:, None])
    (fq * 3.0).sum().backward()
    np.testing.assert_array_equal(tw.grad.numpy(), np.full(tw.shape, 3.0, np.float32))


@pytest.mark.parametrize("dtype,x_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                           ("bfloat16", "float32")])
@pytest.mark.parametrize("use_bias", [True, False])
def test_quant_linear_matches_quant_dense(dtype, x_dtype, use_bias):
    """In bfloat16 compute a bfloat16 input is upcast and a float32 one (a
    LayerNorm's output) quantized as it is; the bias is added in float32."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    jq, js = jax_int8.quantize_kernel(jnp.asarray(w))
    params = {"layer": {"kernel_q8": jq, "kernel_scale": js}}
    if use_bias:
        params["layer"]["bias"] = jnp.asarray(b)

    class Wrap(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return jax_int8.QuantDense(16, use_bias=use_bias, dtype=getattr(jnp, dtype), name="layer")(x)

    jx = jnp.asarray(x).astype(x_dtype)
    want = np.asarray(Wrap().apply({"params": params}, jx).astype(jnp.float32))
    layer = int8.QuantLinear(32, 16, bias=use_bias, dtype=getattr(torch, dtype))
    layer.load_state_dict({k.split(".", 1)[1]: v for k, v in from_jax_variables({"params": params}).items()})
    got = layer(torch.from_numpy(x).to(getattr(torch, x_dtype))).float()
    assert got.dtype == torch.float32 and layer(torch.from_numpy(x)).dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)


def test_quantize_state_dict_refuses_a_shape_mismatch():
    template = {"a.weight_q8": torch.zeros((9, 4), dtype=torch.int8), "a.weight_scale": torch.ones(9)}
    with pytest.raises(ValueError):
        int8.quantize_state_dict({"a.weight": torch.ones(8, 4)}, template)


# ----------------------------------------------------------- the QAT mask


def _port_mask_of(jax_mask):
    """vpt_tpu's nested {…: {"kernel": bool}} mask → {state_dict name: bool}."""
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                out[torch_key(path + (k,))] = bool(v)

    walk(jax_mask, ())
    return out


@pytest.mark.parametrize("model", ["policy", "idm"])
def test_qat_mask_equals_vpt_tpu_key_for_key(model):
    from vpt_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_dp=1, devices=jax.devices()[:1])
    if model == "policy":
        from vpt_tpu.training.bc import BCTrainer as JaxTrainer
        from vpt_tpu_torch.training.bc import BCTrainer as Trainer

        from test_torch_training import PI_KWARGS, TINY_KWARGS as KWARGS
        jax_hp = hp = None
    else:
        from vpt_tpu.training.idm import IDMHyperparams as JaxHyperparams
        from vpt_tpu.training.idm import IDMTrainer as JaxTrainer
        from vpt_tpu_torch.training.idm import IDMHyperparams, IDMTrainer as Trainer

        from test_torch_idm import PI_KWARGS, IDM_TINY_KWARGS as KWARGS
        jax_hp, hp = JaxHyperparams(window=8), IDMHyperparams(window=8)
    jax_mask = _port_mask_of(JaxTrainer(KWARGS, PI_KWARGS, hp=jax_hp, mesh=mesh, qat_dense=True)._qat_mask())
    trainer = Trainer(KWARGS, PI_KWARGS, hp=hp, qat_dense=True, device="cpu")
    trainer.init()
    mask = trainer.qat_mask()
    assert mask == jax_mask
    on = {k for k, v in mask.items() if v}
    assert "net.recurrent_layer.blocks.0.r.orc_block.q_layer.weight" in on
    assert not any(k.startswith(("pi_head.", "value_head.", "net.img_process.cnn.")) for k in on)
    # every marked weight's layer runs fake-quantized, and no other layer does
    flagged = {n for n, m in trainer.policy.named_modules() if getattr(m, "fake_quant", False)}
    assert {k.rsplit(".layer.weight", 1)[0].rsplit(".weight", 1)[0] for k in on} == flagged


# ------------------------------------------------------- quantized agents


def _record_quant_inputs_jax(apply, variables, *args):
    """``apply(variables, *args)`` of a flax module, jitted, recording the
    input of every QuantDense (sown from an interceptor), by torch name."""

    def interceptor(next_fun, fargs, kwargs, context):
        if isinstance(context.module, jax_int8.QuantDense) and context.method_name == "__call__":
            context.module.sow("intermediates", "quant_input", fargs[0])
        return next_fun(*fargs, **kwargs)

    def run(variables, *args):
        with fnn.intercept_methods(interceptor):
            return apply(variables, *args, mutable=["intermediates"])

    out, sown = jax.jit(run)(variables, *args)
    seen = {}

    def walk(tree, path):
        for k, v in tree.items():
            if k == "quant_input":
                seen[torch_key(path + ("kernel_q8",))[: -len(".weight_q8")]] = [np.asarray(x, np.float32) for x in v]
            elif isinstance(v, dict):
                walk(v, path + (k,))

    walk(jax.tree.map(lambda x: x, dict(sown["intermediates"])), ())
    return out, seen


def _record_quant_inputs_torch(model, fn):
    seen, handles = {}, []
    for name, m in model.named_modules():
        if isinstance(m, int8.QuantLinear):
            handles.append(m.register_forward_pre_hook(
                lambda mod, args, name=name: seen.setdefault(name, []).append(args[0].float().numpy())))
    try:
        out = fn()
    finally:
        for h in handles:
            h.remove()
    return out, seen


def _code_flips(port_inputs, jax_inputs):
    """(codes differing, codes in all, largest difference) over every int8
    layer's input activations."""
    assert port_inputs and port_inputs.keys() == jax_inputs.keys(), set(port_inputs) ^ set(jax_inputs)
    flips = total = worst = 0
    for name in port_inputs:
        assert len(port_inputs[name]) == len(jax_inputs[name]), name
        for a, b in zip(port_inputs[name], jax_inputs[name]):
            qa = int8.dynamic_quantize_rows(torch.from_numpy(a))[0].numpy().astype(np.int32)
            qb = np.asarray(jax_int8.dynamic_quantize_rows(jnp.asarray(b))[0]).astype(np.int32)
            flips += int((qa != qb).sum())
            total += qa.size
            worst = max(worst, int(np.abs(qa - qb).max()))
    return flips, total, worst


def _assert_quant_state_equal(port_sd, jax_variables):
    """The port's int8 codes and scales against vpt_tpu's quantized tree,
    bit for bit."""
    want = from_jax_variables(jax.tree.map(np.asarray, jax_variables))
    keys = [k for k in want if k.endswith((".weight_q8", ".weight_scale"))]
    assert keys and set(keys) == {k for k in port_sd if k.endswith((".weight_q8", ".weight_scale"))}
    for k in keys:
        assert port_sd[k].dtype == want[k].dtype, k
        assert torch.equal(port_sd[k], want[k]), k


def test_quantized_idm_agent_matches_vpt_tpu():
    from vpt_tpu.agent import IDMAgent as JaxIDMAgent
    from vpt_tpu_torch.agent import IDMAgent

    from test_torch_idm import IDM_TINY_KWARGS, PI_KWARGS

    jf = JaxIDMAgent(IDM_TINY_KWARGS, PI_KWARGS)
    jf._ensure_variables()
    jq = JaxIDMAgent(IDM_TINY_KWARGS, PI_KWARGS, quantize_dense=True)
    jq.variables = jax.tree.map(jnp.asarray, jf.variables)
    jq._maybe_quantize()
    agent = IDMAgent(IDM_TINY_KWARGS, PI_KWARGS, device="cpu", quantize_dense=True)
    agent.policy.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, jf.variables)), strict=True)
    frames = np.random.default_rng(0).integers(0, 256, (1, 8, 64, 64, 3), dtype=np.uint8)
    first = np.zeros((1, 8), bool)

    (jout, _), jin = _record_quant_inputs_jax(jq.policy.apply, jq.variables, jnp.asarray(frames),
                                               jnp.asarray(first), jq.hidden_state)
    jlogits = jout["pi_logits"]
    agent._maybe_quantize()
    _assert_quant_state_equal(agent.policy.state_dict(), jq.variables)
    with torch.no_grad():
        (out, _), pin = _record_quant_inputs_torch(agent.policy, lambda: agent.policy(
            torch.from_numpy(frames), torch.from_numpy(first), agent.hidden_state))
    # vpt_tpu records the input of the IDM's lastlayer, whose output both discard; the port does not run it
    assert "net.lastlayer.layer" in jin and "net.lastlayer.layer" not in pin
    del jin["net.lastlayer.layer"]
    flips, total, worst = _code_flips(pin, jin)
    print(f"int8 IDM: {flips} of {total} activation codes differ from vpt_tpu's (largest difference {worst})")
    assert worst <= 1 and flips <= CODE_FLIP_SHARE * total
    tol = QUANT_LOGIT_TOL if flips else FLOAT_TOL
    for k in jlogits:
        np.testing.assert_allclose(out["pi_logits"][k].numpy(), np.asarray(jlogits[k]), rtol=tol, atol=tol, err_msg=k)
    # the public API labels on the quantized graph
    assert agent.predict_actions(np.zeros((3, 90, 160, 3), np.uint8))["camera"].shape == (1, 3, 2)


def test_quantized_minerl_agent_matches_vpt_tpu():
    from vpt_tpu.agent import MineRLAgent as JaxAgent
    from vpt_tpu.models.policy import policy_initial_state as jax_initial_state
    from vpt_tpu_torch.agent import MineRLAgent
    from vpt_tpu_torch.checkpoint import save_weights
    from vpt_tpu_torch.models.policy import policy_initial_state

    from test_torch_training import PI_KWARGS, TINY_KWARGS

    kwargs = dict(TINY_KWARGS, img_shape=[64, 64, 3])
    jf = JaxAgent(policy_kwargs=kwargs, pi_head_kwargs=PI_KWARGS, batch_size=2, decode_on_device=False)
    jf._ensure_variables()
    jq = JaxAgent(policy_kwargs=kwargs, pi_head_kwargs=PI_KWARGS, batch_size=2, decode_on_device=False,
                  quantize_dense=True)
    jq.variables = jax.tree.map(jnp.asarray, jf.variables)
    jq._maybe_quantize()
    agent = MineRLAgent(device="cpu", policy_kwargs=kwargs, pi_head_kwargs=PI_KWARGS, batch_size=2,
                        quantize_dense=True)
    float_sd = from_jax_variables(jax.tree.map(np.asarray, jf.variables))
    with torch.no_grad():  # the quantized agent loads float weights and quantizes them again
        f = MineRLAgent(device="cpu", policy_kwargs=kwargs, pi_head_kwargs=PI_KWARGS, batch_size=2)
        f.policy.load_state_dict(float_sd, strict=True)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        save_weights(f"{tmp}/f.weights", f.policy)
        agent.load_weights(f"{tmp}/f.weights")
    _assert_quant_state_equal(agent.policy.state_dict(), jq.variables)

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 4, 64, 64, 3), dtype=np.uint8)
    first = np.zeros((2, 4), bool)
    first[1, 2] = True
    state = jax_initial_state(jq.cfg, 2)
    (jout, _), jin = _record_quant_inputs_jax(jq.policy.apply, jq.variables, jnp.asarray(frames),
                                               jnp.asarray(first), state)
    with torch.no_grad():
        (out, _), pin = _record_quant_inputs_torch(agent.policy, lambda: agent.policy(
            torch.from_numpy(frames), torch.from_numpy(first), policy_initial_state(agent.cfg, 2)))
    flips, total, worst = _code_flips(pin, jin)
    print(f"int8 policy: {flips} of {total} activation codes differ from vpt_tpu's (largest difference {worst})")
    assert worst <= 1 and flips <= CODE_FLIP_SHARE * total
    tol = QUANT_LOGIT_TOL if flips else FLOAT_TOL
    for k in jout["pi_logits"]:
        np.testing.assert_allclose(out["pi_logits"][k].numpy(), np.asarray(jout["pi_logits"][k]),
                                   rtol=tol, atol=tol, err_msg=k)
    np.testing.assert_allclose(out["vpred"].numpy(), np.asarray(jout["vpred"]),
                               atol=QUANT_VALUE_TOL if flips else 1e-5)
    # the stepped t=1 serving path (ring cache, 2 rows an int8 product) against the float agent (vpt_tpu's rule)
    obs = [{"pov": rng.integers(0, 256, (360, 640, 3), dtype=np.uint8)} for _ in range(2)]
    np.testing.assert_allclose(agent.predict_value(obs), f.predict_value(obs), atol=0.15)


# ------------------------------------------------------------------- QAT


@pytest.mark.parametrize("model", ["bc", "idm"])
def test_qat_train_step_loss(model):
    """A QAT step's loss equals the plain trainer's loss on fake-quantized
    weights (rtol 1e-6), and vpt_tpu's QAT loss from the same weights
    (rtol 1e-5, the port's BC parity tolerance)."""
    from vpt_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_dp=1, devices=jax.devices()[:1])
    rng = np.random.default_rng(11)
    if model == "bc":
        from vpt_tpu.training.bc import BCTrainer as JaxTrainer
        from vpt_tpu_torch.training.bc import BCTrainer as Trainer

        from test_torch_training import PI_KWARGS, TINY_KWARGS as KWARGS

        b, t, hw = 3, 4, 32
        jax_hp = hp = None
        batch = {"frames": rng.integers(0, 256, (b, t, hw, hw, 3), dtype=np.uint8),
                 "buttons": rng.integers(0, 8641, (b, t)).astype(np.int32),
                 "camera": rng.integers(0, 121, (b, t)).astype(np.int32),
                 "firsts": np.zeros((b, t), bool), "mask": np.ones((b, t), bool)}
        batch["firsts"][:, 0] = True
    else:
        from vpt_tpu.training.idm import IDMHyperparams as JaxHyperparams
        from vpt_tpu.training.idm import IDMTrainer as JaxTrainer
        from vpt_tpu_torch.training.idm import IDMHyperparams, IDMTrainer as Trainer

        from test_torch_idm import IDM_TINY_KWARGS as KWARGS
        from test_torch_idm import PI_KWARGS

        b, t, hw = 2, 8, 64
        jax_hp, hp = JaxHyperparams(window=8), IDMHyperparams(window=8)
        batch = {"frames": rng.integers(0, 256, (b, t, hw, hw, 3), dtype=np.uint8),
                 "buttons": rng.integers(0, 8641, (b, t)).astype(np.int32),
                 "camera": rng.integers(0, 121, (b, t)).astype(np.int32),
                 "mask": np.ones((b, t), bool)}
    jt = JaxTrainer(KWARGS, PI_KWARGS, hp=jax_hp, mesh=mesh, qat_dense=True, seed=0)
    jt.init()
    sd = from_jax_variables(jax.tree.map(np.asarray, jt.variables))

    def step(trainer):
        if model == "bc":
            return trainer.train_step(batch, trainer.initial_state(b))[1]
        return trainer.train_step(batch)[0]

    qat = Trainer(KWARGS, PI_KWARGS, hp=hp, qat_dense=True, device="cpu")
    qat.init()
    qat.policy.load_state_dict(sd, strict=True)
    mask = qat.qat_mask()
    plain = Trainer(KWARGS, PI_KWARGS, hp=hp, device="cpu")
    plain.init()
    with torch.no_grad():
        plain.policy.load_state_dict(int8.fake_quant_dense_params(sd, mask), strict=True)
    loss_qat, loss_plain = float(step(qat)), float(step(plain))
    np.testing.assert_allclose(loss_qat, loss_plain, rtol=1e-6)
    if model == "bc":
        _, jloss, _ = jt.train_step(batch, jt.initial_state(b))
    else:
        jloss, _ = jt.train_step(batch)
    np.testing.assert_allclose(loss_qat, float(jloss), rtol=1e-5)
    # the float master weights trained, and stay float
    assert all(p.dtype == torch.float32 for p in qat.policy.parameters())
    assert not torch.equal(qat.policy.state_dict()["net.lastlayer.layer.weight"], sd["net.lastlayer.layer.weight"])
