"""The port's remaining reference API against vpt_tpu's, on the CPU:
strided attention (mask, forward and gradients), the recorder jsonl writer,
the cursor composite (numpy and native), the single-step ``DataLoader``,
``utils/minecraft.py`` and ``AgreementMeter``.

Tolerances: strided attention's output and gradients 1e-5 (float32 sums in
another order); normalised entropies rtol 1e-6; everything else exactly.
The loader skips where the native library cannot be built (no libav); the
composite then checks its numpy fallback."""

import torch_cpu

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.actions import json_actions as jax_json
from vpt_tpu.data import cursor as jax_cursor
from vpt_tpu.data import loader as jax_loader
from vpt_tpu.models.heads import HeadSpec as JaxHeadSpec
from vpt_tpu.ops import strided_attention as jax_strided
from vpt_tpu.utils import metrics as jax_metrics
from vpt_tpu.utils import minecraft as jax_minecraft
from vpt_tpu_torch.actions import json_actions
from vpt_tpu_torch.data import cursor, loader, video
from vpt_tpu_torch.models.heads import HeadSpec
from vpt_tpu_torch.ops import strided_attention
from vpt_tpu_torch.utils import metrics, minecraft


@pytest.fixture(autouse=True)
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


# ---------------------------------------------------------- strided attention

@pytest.mark.parametrize("t,T,stride,maxlen", [(6, 6, 2, 2), (4, 12, 3, 3), (8, 16, 4, 2)])
def test_strided_mask_matches_vpt_tpu(t, T, stride, maxlen):
    m = strided_attention.strided_mask(t, T, stride, maxlen).numpy()
    np.testing.assert_array_equal(m, np.asarray(jax_strided.strided_mask(t, T, stride, maxlen)))
    for i in range(t):
        for j in range(T):
            d = (T - t) + i - j
            assert m[i, j] == (d >= 0 and d % stride == 0 and d // stride < maxlen), (i, j)


@pytest.mark.parametrize("extra,use_muP_factor", [(False, False), (True, True)])
def test_strided_attention_and_gradients_match_vpt_tpu(extra, use_muP_factor):
    rng = np.random.default_rng(0)
    B, H, t, T, d = 2, 2, 6, 10, 8
    q, k, v = (rng.normal(size=(B, H, n, d)).astype(np.float32) for n in (t, T, T))
    e = rng.normal(size=(B, H, t, T)).astype(np.float32) if extra else None
    dO = rng.normal(size=(B, H, t, d)).astype(np.float32)

    def jax_loss(q, k, v):
        out = jax_strided.strided_attention(q, k, v, 2, 3, None if e is None else jnp.asarray(e), use_muP_factor)
        return jnp.sum(out * dO), out

    (_, jout), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = strided_attention.strided_attention(tq, tk, tv, 2, 3, None if e is None else torch.from_numpy(e),
                                              use_muP_factor)
    (out * torch.from_numpy(dO)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_strided_attention_only_same_phase():
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.normal(size=(1, 1, 8, 4)).astype(np.float32)) for _ in range(2))
    v = torch.zeros((1, 1, 8, 4))
    v[0, 0, 1] = 100.0  # an odd-phase key poisoned
    out = strided_attention.strided_attention(q, k, v, stride=2, maxlen=4)
    assert out[0, 0, 0].abs().max() < 1e-3 and out[0, 0, 2].abs().max() < 1e-3  # even queries never see it
    assert out[0, 0, 3].abs().max() > 1.0


# ------------------------------------------------------------- json writer

def _env_actions(n, seed=0):
    rng = np.random.default_rng(seed)
    names = list(json_actions.NOOP_ACTION)
    out = []
    for _ in range(n):
        a = dict(json_actions.NOOP_ACTION, camera=np.array([0, 0]))
        for name in rng.choice([x for x in names if x != "camera"], rng.integers(0, 4), replace=False):
            a[name] = 1
        a["camera"] = np.array([float(rng.integers(-10, 11)), float(rng.integers(-10, 11))])
        out.append(a)
    return out


def test_recorder_jsonl_writer_matches_vpt_tpu_and_round_trips():
    actions = _env_actions(60)
    writer, jwriter = json_actions.RecorderJsonlWriter(), jax_json.RecorderJsonlWriter()
    for i, a in enumerate(actions):
        row = writer.step(a, mouse_xy=(float(i), 2.0 * i))
        assert row == jwriter.step(a, mouse_xy=(float(i), 2.0 * i))
        back, null = json_actions.json_action_to_env_action(row)
        held = {k for k, v in a.items() if k != "camera" and v}
        assert null == (not held and not np.any(a["camera"]))
        for k in json_actions.NOOP_ACTION:
            np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(a[k]).astype(np.asarray(back[k]).dtype),
                                          err_msg=k)
        assert json_actions.env_action_to_json_action(a) == jax_json.env_action_to_json_action(a)


def test_recorder_writer_tracks_gui_hotbar_and_new_buttons():
    w = json_actions.RecorderJsonlWriter()
    noop = dict(json_actions.NOOP_ACTION, camera=np.array([0, 0]))
    rows = [w.step(dict(noop, attack=1)), w.step(dict(noop, attack=1, use=1)), w.step(dict(noop, inventory=1)),
            w.step(dict(noop, inventory=1)), w.step(dict(noop, ESC=1)), w.step(dict(noop, **{"hotbar.4": 1}))]
    assert [r["mouse"]["newButtons"] for r in rows[:2]] == [[0], [1]]
    assert [r["isGuiOpen"] for r in rows] == [False, False, True, True, False, False]
    assert rows[-1]["hotbar"] == 3


# ---------------------------------------------------------------- composite

@pytest.mark.parametrize("x,y", [(10, 5), (55, 30), (0, 0), (63, 35)])
def test_cursor_composite_is_byte_equal(x, y):
    rgb, alpha = cursor.default_cursor()
    img = np.random.default_rng(x + y).integers(0, 256, (36, 64, 3), dtype=np.uint8)
    ours, theirs, native = img.copy(), img.copy(), img.copy()
    cursor.composite_images_with_alpha(ours, rgb, alpha[..., None] / 255.0, x, y)
    jax_cursor.composite_images_with_alpha(theirs, rgb, alpha[..., None] / 255.0, x, y)
    np.testing.assert_array_equal(ours, theirs)
    video.native_composite_alpha(native, rgb, alpha, x, y)
    np.testing.assert_array_equal(native, ours)
    assert not np.array_equal(ours, img)


def test_native_composite_alpha_falls_back_to_numpy(monkeypatch):
    def no_library():
        raise RuntimeError("no libav")

    monkeypatch.setattr(video, "_load_library", no_library)
    rgb, alpha = cursor.default_cursor()
    img = np.random.default_rng(1).integers(0, 256, (36, 64, 3), dtype=np.uint8)
    ours, theirs = img.copy(), img.copy()
    video.native_composite_alpha(ours, rgb, alpha, 20, 10)
    jax_cursor.composite_images_with_alpha(theirs, rgb, alpha[..., None] / 255.0, 20, 10)
    np.testing.assert_array_equal(ours, theirs)


# -------------------------------------------------------- single-step loader

def test_step_data_loader_matches_vpt_tpu(tmp_path):
    from test_torch_data import _dataset

    try:
        video.build()
    except RuntimeError as e:
        pytest.skip(f"native video library of the port cannot be built: {e}")
    if torch_cpu.jax_native_video() is None:
        pytest.skip("native video library of vpt_tpu unavailable (libav)")
    _dataset(tmp_path)
    kw = dict(n_workers=2, batch_size=2, n_epochs=2, seed=5)
    batches = []
    for make in (loader.DataLoader, jax_loader.DataLoader):
        ld = make(str(tmp_path), **kw)
        try:
            batches.append(list(ld))
        finally:
            ld.close()
    ours, theirs = batches
    assert len(ours) == len(theirs) >= 3
    for (frames, acts, ids), (jframes, jacts, jids) in zip(ours, theirs):
        assert ids == jids
        for f, jf in zip(frames, jframes):
            np.testing.assert_array_equal(f, jf)
        for a, ja in zip(acts, jacts):
            assert a.keys() == ja.keys()
            for key in a:
                np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(ja[key]), err_msg=key)
    with pytest.raises(ValueError):
        loader.DataLoader(str(tmp_path), n_workers=1, batch_size=2)


# ------------------------------------------------------ minecraft, metrics

def test_store_args_records_constructor_arguments():
    class Thing:
        @minecraft.store_args
        def __init__(self, a, b=2, *, c=3):
            pass

    class JaxThing:
        @jax_minecraft.store_args
        def __init__(self, a, b=2, *, c=3):
            pass

    for args, kw in (((1,), {}), ((1, 5), {"c": 7}), ((), {"a": 0, "b": 1})):
        assert vars(Thing(*args, **kw)) == vars(JaxThing(*args, **kw))


def test_norm_cat_entropy_matches_vpt_tpu():
    rng = np.random.default_rng(0)
    specs = (HeadSpec("buttons", (1,), 6), HeadSpec("camera", (2,), 5), HeadSpec("cont", (3,), kind="gaussian"))
    jspecs = (JaxHeadSpec("buttons", (1,), 6), JaxHeadSpec("camera", (2,), 5),
              JaxHeadSpec("cont", (3,), kind="gaussian"))
    logits = {"buttons": rng.normal(size=(4, 3, 1, 6)), "camera": rng.normal(size=(4, 3, 2, 5)),
              "cont": rng.normal(size=(4, 3, 3, 2))}
    logits = {k: (v - np.log(np.exp(v).sum(-1, keepdims=True))).astype(np.float32) if k != "cont"
              else v.astype(np.float32) for k, v in logits.items()}
    masks = {"camera": rng.random((4, 3, 2, 5)) < 0.6}
    masks["camera"][0, 0, 0] = [True, False, False, False, False]  # a single option counts for nothing
    for m in (None, masks):
        ours = minecraft.norm_cat_entropy({k: torch.from_numpy(v) for k, v in logits.items()}, specs,
                                          None if m is None else {k: torch.from_numpy(v) for k, v in m.items()})
        theirs = jax_minecraft.norm_cat_entropy({k: jnp.asarray(v) for k, v in logits.items()}, jspecs, m)
        np.testing.assert_allclose(ours[0].numpy(), np.asarray(theirs[0]), rtol=1e-6)
        np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))


def test_agreement_meter_matches_vpt_tpu():
    rng = np.random.default_rng(0)
    ours, theirs = metrics.AgreementMeter(), jax_metrics.AgreementMeter()
    assert ours.summary() == theirs.summary() == {"frames": 0}
    for _ in range(20):
        pred = {k: np.array([rng.integers(0, 2)]) for k in ("attack", "forward", "jump")}
        pred["camera"] = rng.normal(size=2) * 5
        rec = {k: np.array([rng.integers(0, 2)]) for k in ("attack", "forward")}
        rec["camera"] = rng.normal(size=2) * 5
        ours.add(pred, rec)
        theirs.add(pred, rec)
    assert ours.summary() == theirs.summary()
    assert ours.summary()["frames"] == 20
