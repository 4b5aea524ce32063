"""Kernel C1's CPU side (ops/conv.py): the plain version, the routing
predicate at the models' one routing point, the autograd Function through
the plain path, the ``conv_flops`` and ``conv_tc_flops`` counters, and the
two benchmark readers of their share.  The kernel itself runs on the card
only (tests/test_torch_kernels.py).

Tolerances.  The plain version is ``F.conv2d`` then ReLU, compared bit for
bit.  The Function's gradients: ``gradcheck`` in float64 at its default
tolerances; under ``remat_call`` the same float32 arithmetic recomputed,
so bit for bit too."""

import math
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from portbench import manifest
from vpt_tpu_torch import config
from vpt_tpu_torch.models.impala import ImpalaCNN
from vpt_tpu_torch.models.layers import REMAT_CNN_SPAN, FanInInitLayer, remat_call
from vpt_tpu_torch.models.policy import InverseActionNet
from vpt_tpu_torch.ops import conv
from vpt_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


def _cuda_like(shape, dtype=torch.float32):
    """An input as the predicate sees it on the card: its device, dtype and shape."""
    return SimpleNamespace(is_cuda=True, dtype=dtype, shape=torch.Size(shape), dim=lambda: len(shape))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_plain_version_is_conv2d_then_relu(bias, relu):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, 7, 12), generator=g)
    w = torch.randn((5, 8, 3, 3), generator=g)
    b = torch.randn((5,), generator=g) if bias else None
    want = F.conv2d(x, w, b, padding=1)
    want = F.relu(want) if relu else want
    launches = conv.launches
    assert torch.equal(conv.conv3x3_fwd_plain(x, w, b, relu), want)
    assert torch.equal(conv.conv3x3_fwd(x, w, b, relu), want)  # a CPU tensor runs the plain version
    assert torch.equal(torch.ops.vpt_torch.conv3x3_fwd(x, w, b, relu), want)
    assert conv.launches == launches


def _conv_inputs(model, forward):
    """[(layer, the shape of its input)] of every conv layer of ``model``
    that ``forward()`` (on meta tensors) runs, in order."""
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, args: seen.append((m, tuple(args[0].shape))))
             for m in model.modules() if isinstance(m, FanInInitLayer) and m.layer_type != "linear"]
    with torch.no_grad():
        forward()
    for h in hooks:
        h.remove()
    return seen


@pytest.mark.parametrize("width,n_convs", [(2, 15), (3, 15)])
def test_the_policies_route_every_conv_but_the_first(width, n_convs):
    """The 2x and 3x foundation policies' Impala CNNs: every conv goes to
    C1 on a CUDA f32 input but the first, whose input has 3 channels."""
    cfg = config.foundation_policy_config(width)
    cnn = ImpalaCNN(cfg.img_shape, cfg.chans, 256, cfg.impala_nblock, post_pool_groups=cfg.impala_post_pool_groups,
                    group_norm_groups=cfg.group_norm_groups, device="meta")
    seen = _conv_inputs(cnn, lambda: cnn(torch.empty((1, 2) + tuple(cfg.img_shape), device="meta")))
    assert len(seen) == n_convs
    routed = [conv.routes_to_c1(_cuda_like(shape), m.layer.weight, m.stride, m.padding) for m, shape in seen]
    assert routed == [False] + [True] * (n_convs - 1)
    assert seen[0][1][1] == 3
    widths = {shape[-1] for _, shape in seen[1:]}
    assert widths == {64, 32, 16}


def test_the_idm_routes_its_2d_convs_and_not_its_conv3d():
    cfg = config.PolicyConfig.from_kwargs(config.IDM_4X_KWARGS)
    net = InverseActionNet(cfg, device="meta")
    frames = torch.empty((2, 8, 128, 128, 3), device="meta")  # (B, T, H, W, C) preprocessed
    seen = _conv_inputs(net, lambda: net.img_process.forward_nchw(*net.conv3d_front(frames)))
    c3, seen = seen[0][0], seen[1:]
    assert c3 is net.conv3d_layer
    assert not conv.routes_to_c1(_cuda_like((2, 3, 8, 128, 128)), c3.layer.weight, c3.stride, c3.padding)
    routed = [conv.routes_to_c1(_cuda_like(shape), m.layer.weight, m.stride, m.padding) for m, shape in seen]
    assert len(routed) == 15 and all(routed)
    assert {(m.layer.weight.shape[1], m.layer.weight.shape[0], s[-1]) for m, s in seen} == {
        (128, 256, 128), (256, 256, 64), (256, 512, 64), (512, 512, 32), (512, 512, 16)}


@pytest.mark.parametrize("case", ["qualifies", "bfloat16", "cpu", "three_channels", "stride", "padding", "kernel",
                                  "conv3d", "width", "narrow_row", "too_wide", "bf16_weight"])
def test_the_predicate_turns_away_what_c1_does_not_take(case):
    shape, dtype, stride, padding = (4, 64, 32, 32), torch.float32, 1, 1
    w = torch.empty((64, 64, 3, 3), device="meta")
    x = _cuda_like(shape)
    if case == "bfloat16":
        x = _cuda_like(shape, torch.bfloat16)
    elif case == "cpu":
        x = torch.empty(shape)
    elif case == "three_channels":
        x, w = _cuda_like((4, 3, 32, 32)), torch.empty((64, 3, 3, 3), device="meta")
    elif case == "stride":
        stride = (2, 2)
    elif case == "padding":
        padding = 0
    elif case == "kernel":
        w = torch.empty((64, 64, 5, 5), device="meta")
    elif case == "conv3d":
        x, w = _cuda_like((4, 64, 8, 32, 32)), torch.empty((64, 64, 3, 3, 3), device="meta")
    elif case == "width":
        x = _cuda_like((4, 64, 32, 30))
    elif case == "narrow_row":
        x = _cuda_like((4, 64, 32, 2))
    elif case == "too_wide":
        x = _cuda_like((4, 64, 32, conv.MAX_WIDTH + conv.WIDTH_STEP))
    elif case == "bf16_weight":
        w = torch.empty((64, 64, 3, 3), device="meta", dtype=torch.bfloat16)
    assert conv.routes_to_c1(x, w, stride, padding) == (case == "qualifies")


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_the_function_gradchecks_through_the_plain_path(bias, relu):
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 8, 5, 8), generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn((3, 8, 3, 3), generator=g, dtype=torch.float64, requires_grad=True)
    b = torch.randn((3,), generator=g, dtype=torch.float64, requires_grad=True) if bias else None
    inputs = (x, w, b) if bias else (x, w)
    assert torch.autograd.gradcheck(lambda *a: conv.conv3x3_autograd(a[0], a[1], a[2] if bias else None, relu),
                                    inputs)


def test_the_function_under_remat_equals_autograd_of_the_plain_version():
    g = torch.Generator().manual_seed(2)
    w0, w1 = (torch.randn((8, 8, 3, 3), generator=g).div_(8).requires_grad_() for _ in range(2))
    b1 = torch.randn((8,), generator=g, requires_grad=True)
    x = torch.randn((3, 8, 6, 8), generator=g, requires_grad=True)
    dy = torch.randn((3, 8, 6, 8), generator=g)

    def two(fn):
        return lambda x: fn(fn(x, w0, None), w1, b1)

    def grads(y):
        return torch.autograd.grad((y * dy).sum(), (x, w0, w1, b1))

    plain = grads(two(lambda x, w, b: F.relu(F.conv2d(x, w, b, padding=1)))(x))
    profiling.counters(reset=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = grads(remat_call(two(lambda x, w, b: conv.conv3x3_autograd(x, w, b, True)), x,
                               span_name=REMAT_CNN_SPAN))
    assert profiling.counters(reset=True).get("remat_recomputes") == 1
    profiling.counters(reset=True)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


def _stack():
    g = torch.Generator().manual_seed(3)
    c3 = FanInInitLayer(3, 8, layer_type="conv3d", kernel_size=(3, 1, 1), padding=(1, 0, 0))
    first = FanInInitLayer(3, 8, layer_type="conv")
    body = FanInInitLayer(8, 16, layer_type="conv", group_norm_groups=1)
    strided = FanInInitLayer(8, 8, layer_type="conv", stride=2)
    dense = FanInInitLayer(16 * 6 * 8, 4, layer_type="linear")
    for m in (c3, first, body, strided, dense):
        m.reset_parameters(generator=g)

    def run(x):  # x (2, 3, 5, 6, 8): a conv3d over 5 frames, then 2D convs on frame 0
        y = c3(x)[:, :, 0]
        y = body(first(x[:, :, 0]))
        strided(first(x[:, :, 0]))
        return dense(y.flatten(1))

    flops = {"c3": 2 * (2 * 8 * 5 * 6 * 8) * 3 * 3, "first": 2 * (2 * 8 * 6 * 8) * 3 * 9,
             "body": 2 * (2 * 16 * 6 * 8) * 8 * 9, "strided": 2 * (2 * 8 * 3 * 4) * 8 * 9}
    x = torch.randn((2, 3, 5, 6, 8), generator=g)
    return run, x, flops


def test_conv_counters_count_every_conv_forward_under_a_profiler_and_nothing_without(monkeypatch):
    run, x, flops = _stack()
    profiling.counters(reset=True)
    run(x)  # no profiler: nothing counted
    assert profiling.counters() == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        run(x)
    got = profiling.counters(reset=True)
    # every conv and conv3d forward, each once ("first" runs twice), none on C1 on the CPU
    assert got == {"conv_flops": flops["c3"] + 2 * flops["first"] + flops["body"] + flops["strided"]}
    # where the predicate routes (as on the card: the 3x3 stride-1 convs of 8 or more input
    # channels), C1's FLOPs count under conv_tc_flops as well
    routes = conv.routes_to_c1
    monkeypatch.setattr(conv, "routes_to_c1", lambda x, w, s, p: routes(_cuda_like(tuple(x.shape)), w, s, p))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = run(x)
    got = profiling.counters(reset=True)
    assert got == {"conv_flops": flops["c3"] + 2 * flops["first"] + flops["body"] + flops["strided"],
                   "conv_tc_flops": flops["body"]}
    monkeypatch.undo()
    assert torch.equal(out, run(x))  # the routed layer ran the plain version: the same numbers


def _reader(name):
    return manifest.load_module(manifest.metric_file(name), f"test_metric_{name}")


@pytest.mark.parametrize("name,kind,other", [("conv_tc_pct.label", "label", "train"),
                                             ("conv_tc_pct.train", "train", "label")])
def test_the_readers_take_c1s_share_of_the_conv_flops(name, kind, other):
    reader = _reader(name)
    profiling.counters(reset=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("conv_flops", 800)
        profiling.count("conv_tc_flops", 792)
    run = SimpleNamespace(layer={"kind": kind}, trace_data=object())
    assert math.isclose(reader.read(run), 99.0)
    assert reader.read(SimpleNamespace(layer={"kind": other}, trace_data=object())) is None
    assert reader.read(SimpleNamespace(layer={"kind": kind}, trace_data=None)) is None
    profiling.counters(reset=True)
    assert reader.read(run) is None  # a program that counts no conv FLOPs: nothing to read
    assert not hasattr(reader, "OPS")  # declares no operator: C1 runs inside the CNN's spans



def test_the_relu_mask_is_an_autograd_node_of_its_own():
    """As after F.relu, autograd frees the gradient arriving at the ReLU
    before the convolution's backward runs: the mask and the convolution are
    two nodes, and the output is C1's own (a view, no copy)."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((1, 8, 4, 4), generator=g, requires_grad=True)
    w = torch.randn((4, 8, 3, 3), generator=g, requires_grad=True)
    out = conv.conv3x3_autograd(x, w)
    assert type(out.grad_fn).__name__ == "ReLUGradBackward"
    ((node, _),) = out.grad_fn.next_functions
    assert type(node).__name__ == "Conv3x3Backward"
    assert out._base is not None and out._base.grad_fn is node
    plain = conv.conv3x3_autograd(x, w, relu=False)
    assert type(plain.grad_fn).__name__ == "Conv3x3Backward"


@pytest.mark.parametrize("case", ["three_channels", "bfloat16", "bias_shape"])
def test_a_refused_call_names_what_c1_takes_and_what_it_got(case):
    """The predicate answers from plain comparisons; the message, with the
    shapes and types it was given, is formatted only where a call raises."""
    x, w, b = torch.empty((2, 8, 4, 4)), torch.empty((6, 8, 3, 3)), None
    if case == "three_channels":
        x, w = torch.empty((2, 3, 4, 4)), torch.empty((6, 3, 3, 3))
        want = "input channels"
    elif case == "bfloat16":
        x = x.bfloat16()
        want = "float32"
    else:
        b = torch.empty((5,))
        want = r"bias of \(K,\)"
    with pytest.raises(ValueError, match=want) as raised:
        conv._check(x, w, b)
    assert f"x {x.dtype} {tuple(x.shape)}, w {w.dtype} {tuple(w.shape)}" in str(raised.value)
