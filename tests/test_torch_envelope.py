"""PyTorch port, the kernels' envelopes: each kernel module states in one
predicate what its kernel takes (``diffnet_block_takes``,
``flash_mha_takes``, ``mel_kernel_takes``). A CPU tensor takes the plain
version at any width; on the card a call outside the envelope raises,
naming the kernel and the shape, and no caller gives way to the plain
version: the modules call the wrappers at every width. There is no card
here: fake CUDA tensors (``FakeTensorMode``, shapes and dtypes without
data) stand for it, which reach the wrappers' envelope checks; a call
inside the envelope is stopped where the wrapper asks the kernel's library
for its tile plan or its entry point."""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from speech_editing_tpu_torch.modules import transformer, wavenet
from speech_editing_tpu_torch.ops.cuda import diffnet_block as k1_module
from speech_editing_tpu_torch.ops.cuda.diffnet_block import (diffnet_block, diffnet_block_bwd,
                                                             diffnet_block_takes,
                                                             diffnet_block_train)
from speech_editing_tpu_torch.ops.cuda.mel_kernel import mel_kernel_takes, mel_spectrogram
from speech_editing_tpu_torch.ops.flash_attention import (flash_mha, flash_mha_bwd,
                                                          flash_mha_takes)
from speech_editing_tpu_torch.ops.mel import MelConfig
from speech_editing_tpu_torch.ops.mel import mel_spectrogram as mel_plain
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)


class LaunchReached(Exception):
    """Raised in place of the kernel library's tile-plan query."""


@pytest.mark.parametrize("args, takes", [
    ((256, 192, 1, torch.float32), True), ((256, 192, 3, torch.bfloat16), True),
    ((128, 192, 1, torch.float32), True), ((128, 256, 2, torch.bfloat16), True),
    ((256, None, 1, torch.bfloat16), True), ((96, None, 1, torch.float32), False),
    ((96, 192, 1, torch.float32), False), ((256, 128, 1, torch.float32), False),
    ((256, 192, 0, torch.float32), False), ((256, 192, 1, torch.float16), False),
])
def test_diffnet_block_envelope(args, takes):
    assert diffnet_block_takes(*args) is takes


@pytest.mark.parametrize("args, takes", [
    ((64, torch.float32), True), ((128, torch.float32), True), ((36, torch.float32), True),
    ((160, torch.float32), False), ((64, torch.bfloat16), True),
    ((128, torch.bfloat16), True), ((160, torch.bfloat16), False), ((64, torch.float16), False),
])
def test_attention_envelope(args, takes):
    assert flash_mha_takes(*args) is takes


@pytest.mark.parametrize("cfg, dtype, takes", [
    (MelConfig(), torch.float32, True), (MelConfig(hop_size=128), torch.float32, True),
    (MelConfig(fft_size=2048, win_length=2048), torch.float32, False),
    (MelConfig(hop_size=250), torch.float32, False),
    (MelConfig(num_mels=160), torch.float32, False), (MelConfig(), torch.bfloat16, False),
])
def test_mel_envelope(cfg, dtype, takes):
    assert mel_kernel_takes(cfg, dtype) is takes


@pytest.fixture
def card():
    """Fake tensors for the test's body; the card's device."""
    with FakeTensorMode():
        yield torch.device("cuda")


def _block_args(c, h, device="cpu", dtype=torch.float32, b=2, t=9):
    """(x, cond, step, mask, wd, bd, wc, bc, wo, bo) of a block."""
    kw = dict(device=device, dtype=dtype)
    return (torch.randn(b, t, c, **kw), torch.randn(b, t, h, **kw), torch.randn(b, c, **kw),
            torch.ones(b, t, **kw), torch.randn(3 * c, 2 * c, **kw), torch.randn(2 * c, **kw),
            torch.randn(h, 2 * c, **kw), torch.randn(2 * c, **kw), torch.randn(c, 2 * c, **kw),
            torch.randn(2 * c, **kw))


@pytest.mark.parametrize("c, h, dtype, grad", [
    (16, 24, torch.float32, True), (96, 192, torch.float32, False),
    (256, 192, torch.float16, True),
])
def test_a_block_outside_the_envelope_raises_on_the_card(card, c, h, dtype, grad):
    """On the card a width that is not compiled (or a dtype the kernel does
    not take) raises in K1's wrapper, with autograd's Function or without,
    naming the shape."""
    block = diffnet_block_train if grad else diffnet_block
    with pytest.raises(ValueError, match=rf"diffnet_block: C={c}, H={h}, dilation=2.*"
                                         r"outside the kernel's envelope"):
        block(*_block_args(c, h, card, dtype), dilation=2)


@pytest.mark.parametrize("c, h, dtype", [(128, 192, torch.float32), (256, 256, torch.bfloat16)])
def test_a_block_inside_the_envelope_goes_to_the_kernel(card, monkeypatch, c, h, dtype):
    """Widths as compiled pass the envelope: the wrapper goes on to ask the
    kernel's library for its tile plan."""
    def plan(name, dilation, suffix, c_, h_):
        raise LaunchReached((name, suffix, c_, h_))
    monkeypatch.setattr(k1_module, "_fits64", plan)
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    with pytest.raises(LaunchReached, match=rf"'diffnet_block', '{suffix}', {c}, {h}"):
        diffnet_block(*_block_args(c, h, card, dtype), dilation=1)


def test_the_backward_kernel_checks_its_envelope(card):
    x = torch.empty(2, 9, 96, device=card)
    with pytest.raises(ValueError, match=r"diffnet_block_bwd: C=96, dilation=1.*envelope"):
        diffnet_block_bwd(x.new_empty(2, 9, 192), x, x, None, x.new_empty(288, 192),
                          x.new_empty(96, 192))


@pytest.mark.parametrize("c, h", [(16, 24), (96, 40)])
def test_a_block_runs_on_the_cpu_at_any_width(c, h, monkeypatch):
    """On the CPU every width runs, through the same wrapper (its plain
    version), with autograd's gradient reaching the conv weights."""
    calls = []
    real = wavenet.diffnet_block_train
    monkeypatch.setattr(wavenet, "diffnet_block_train",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    block = wavenet.DiffNetResidualBlock(h, c, dilation=2)
    x, cond, step, mask = _block_args(c, h)[:4]
    x.requires_grad_(True)
    xo, skip = block(x, cond, step, mask)
    (xo.sum() + skip.sum()).backward()
    assert calls == [x.shape] and torch.isfinite(x.grad).all()
    assert block.dilated_conv.weight.grad is not None


@pytest.mark.parametrize("d, dtype", [(160, torch.float32), (32, torch.float16),
                                      (160, torch.bfloat16)])
def test_attention_outside_the_envelope_raises_on_the_card(card, d, dtype):
    q = torch.empty(2, 7, 2, d, device=card, dtype=dtype)
    pad = torch.zeros(2, 7, dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match=rf"flash_mha: head width {d}, dtype {dtype}.*"
                                         r"outside the kernel's envelope"):
        flash_mha(q, q, q, pad)
    with pytest.raises(ValueError, match=rf"flash_mha_bwd: head width {d}.*envelope"):
        flash_mha_bwd(q, q, q, q, torch.empty(2, 2, 7, device=card), q, pad)


@pytest.mark.parametrize("dtype, suffix", [(torch.float32, "f32"), (torch.bfloat16, "bf16")])
def test_attention_inside_the_envelope_goes_to_its_form(card, monkeypatch, dtype, suffix):
    """float32 and bf16 heads of width 96 pass the envelope: K3 and K4 ask
    for the entry point of their dtype's form (``attention_{fwd,bwd}_f32`` or
    ``_bf16``), with the logsumexp in float32."""
    from speech_editing_tpu_torch.ops import flash_attention as k3_module

    def entry(name, symbol, argtypes):
        raise LaunchReached(symbol)
    monkeypatch.setattr(k3_module, "kernel_function", entry)
    q = torch.empty(2, 7, 2, 96, device=card, dtype=dtype)
    pad = torch.zeros(2, 7, dtype=torch.bool, device=card)
    with pytest.raises(LaunchReached, match=f"attention_fwd_{suffix}"):
        flash_mha(q, q, q, pad, return_lse=True)
    with pytest.raises(LaunchReached, match=f"attention_bwd_{suffix}"):
        flash_mha_bwd(q, q, q, q, torch.empty(2, 2, 7, device=card), q, pad)
    with pytest.raises(ValueError, match="lse: dtype"):
        flash_mha_bwd(q, q, q, q, torch.empty(2, 2, 7, device=card, dtype=torch.bfloat16), q,
                      pad)


@pytest.mark.parametrize("dim, heads", [(320, 2), (64, 2)])
def test_attention_calls_the_kernel_at_any_width(monkeypatch, dim, heads):
    """The attention module calls K3/K4's Function at every head width (on
    the CPU, their plain versions), so on the card a width outside the
    envelope raises there."""
    calls = []
    real = transformer.flash_mha_train
    monkeypatch.setattr(transformer, "flash_mha_train",
                        lambda q, *a: calls.append(q.shape[-1]) or real(q, *a))
    attn = transformer.MultiheadAttention(dim, heads)
    out = attn(torch.randn(2, 7, dim), key_padding_mask=torch.zeros(2, 7, dtype=torch.bool))
    assert calls == [dim // heads] and torch.isfinite(out).all()


@pytest.mark.parametrize("cfg", [MelConfig(hop_size=250), MelConfig(num_mels=160)])
def test_the_mel_outside_the_envelope_raises_on_the_card(cfg):
    with FakeTensorMode(), \
            pytest.raises(ValueError, match=r"mel_spectrogram: n_fft=1024.*envelope"):
        mel_spectrogram(torch.empty(1, 4000, device="cuda"), cfg)
    wav = torch.randn(1, 4000)      # on the CPU, its plain version
    torch.testing.assert_close(mel_spectrogram(wav, cfg), mel_plain(wav, cfg))
