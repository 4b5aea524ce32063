"""Head dims the kernels do not take whole, on the CPU: the wrappers'
pad-and-slice (ops/windowed_attention.py ``padded_fwd``, ``padded_bwd``)
around a stand-in for the kernel that computes the plain attention at the
scale it is given, against the plain version at the unpadded d.

Held: the output and every gradient within 1e-5 (float32: the padded
columns add exact zeros to the products), the scale the kernel gets being
the unpadded d's (the padded d's moves the output by far more), the kernel
seeing the padded head dim, and the operators' FLOP count being the
unpadded work, as the plain version's is.  On the card the same wrappers
launch B1 and B2 (chip_smoke.py phase 16).
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vpt_tpu_torch.ops import windowed_attention as wa
from vpt_tpu_torch.ops.attention import NEG_BIAS
from vpt_tpu_torch.ops.rel_bias import relattn_bias

TOL = 1e-5


@pytest.fixture(autouse=True)
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


def _inputs(d, seed=0, B=2, H=3, t=6, maxlen=10):
    g = torch.Generator().manual_seed(seed)
    T = t + maxlen
    q, k, v = (torch.randn(s, generator=g) for s in ((B, H, t, d), (B, H, T, d), (B, H, T, d)))
    R = torch.randn((B, H, t, 10), generator=g)
    b_nd = torch.randn((10, maxlen), generator=g)
    mask = torch.rand((B, t, T), generator=g) < 0.7
    mask[..., -1] = True  # every row attends somewhere
    return q, k, v, mask, R, b_nd


def _attention_at(q, k, v, mask, R, b_nd, alpha):
    """softmax(alpha·QKᵀ + relative bias + mask bias)·V at the scale given."""
    logits = alpha * q @ k.transpose(-1, -2) + relattn_bias(R, b_nd, k.shape[2])
    logits = logits + torch.where(mask[:, None], 0.0, NEG_BIAS)
    return torch.softmax(logits, dim=-1) @ v


class StandIn:
    """A kernel stand-in that records the head dim and scale it is called with."""

    def __init__(self):
        self.calls = []

    def fwd(self, q, k, v, mask, R, b_nd, alpha):
        self.calls.append((q.shape[-1], alpha))
        return _attention_at(q, k, v, mask, R, b_nd, alpha)

    def bwd(self, q, k, v, mask, R, b_nd, dO, alpha):
        self.calls.append((q.shape[-1], alpha))
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v, R, b_nd)]
        out = _attention_at(leaves[0], leaves[1], leaves[2], mask, leaves[3], leaves[4], alpha)
        return tuple(x.contiguous() for x in torch.autograd.grad(out, leaves, dO))  # as the kernel's


@pytest.mark.parametrize("d,expect", [(16, 64), (32, 64), (64, 64), (96, 128), (200, 256), (320, 320), (384, 384),
                                      (448, 448), (500, 512), (512, 512)])
def test_kernel_d_is_the_next_multiple_of_64(d, expect):
    assert wa.kernel_d(d) == expect


@pytest.mark.parametrize("d", [0, 513, 1024])
def test_head_dims_past_the_kernels_raise_naming_themselves(d):
    with pytest.raises(ValueError, match=f"head dim {d} "):
        wa.kernel_d(d)


@pytest.mark.parametrize("d", [16, 32, 96, 384])
@pytest.mark.parametrize("muP", [True, False])
def test_padded_forward_equals_the_plain_version(d, muP):
    q, k, v, mask, R, b_nd = _inputs(d)
    kernel = StandIn()
    got = wa.padded_fwd(q, k, v, mask, R, b_nd, muP, kernel.fwd)
    expect = wa.windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, muP)
    assert got.shape == expect.shape and got.is_contiguous()
    assert (got - expect).abs().max().item() <= TOL
    assert kernel.calls == [(wa.kernel_d(d), wa.attention_alpha(d, muP))]
    if wa.kernel_d(d) != d:  # the padded d's scale would be far off: the test can tell
        wrong = _attention_at(q, k, v, mask, R, b_nd, wa.attention_alpha(wa.kernel_d(d), muP))
        assert (wrong - expect).abs().max().item() > 100 * TOL


@pytest.mark.parametrize("d", [16, 32, 96, 384])
def test_padded_backward_equals_the_plain_version(d):
    q, k, v, mask, R, b_nd = _inputs(d, seed=1)
    dO = torch.randn(q.shape, generator=torch.Generator().manual_seed(2))
    kernel = StandIn()
    got = wa.padded_bwd(q, k, v, mask, R, b_nd, dO, True, kernel.bwd)
    expect = wa.windowed_attention_bwd_plain(q, k, v, mask, R, b_nd, dO, True)
    for name, a, b in zip(("dq", "dk", "dv", "dR", "db_nd"), got, expect):
        assert a.shape == b.shape and a.is_contiguous(), name
        assert (a - b).abs().max().item() <= TOL * (1 + b.abs().max().item()), name
    assert kernel.calls == [(wa.kernel_d(d), wa.attention_alpha(d, True))]


@pytest.mark.parametrize("d", [16, 96])
def test_operators_count_the_unpadded_work(d):
    """The operators see the caller's unpadded tensors (the padding is inside
    their CUDA implementations), so their FLOP formulas count what the plain
    version's aten products count at that d."""
    q, k, v, mask, R, b_nd = _inputs(d)
    meta = [x.to("meta") for x in (q, k, v, mask, R, b_nd)]
    with FlopCounterMode(display=False) as on_card:
        out = torch.ops.vpt_torch.windowed_attention_fwd(*meta, True)
        torch.ops.vpt_torch.windowed_attention_bwd(*meta, meta[0], True)
    assert out.shape == q.shape
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    with FlopCounterMode(display=False) as plain:
        wa.windowed_attention_fwd_plain(leaves[0], leaves[1], leaves[2], mask, R.requires_grad_(True),
                                        b_nd.requires_grad_(True), True).sum().backward()
    assert on_card.get_total_flops() == plain.get_total_flops() == sum(wa.attention_flops(q, k, R, b_nd))
