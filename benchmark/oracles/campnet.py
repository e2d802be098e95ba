"""How ``correct`` is decided for the ``campnet`` configuration, against the
plain reference (``reference/campnet.py``, ``reference/hifigan.py``,
``reference/frontend.py``), float32 with TF32 off.

Served edits: for a sample of the window's requests the reference works out
again from the generated request the front end (the edited phones, the
source's mel, the frame mask of the edited words), the model's fine mel at
the request's exact length, the composite and the vocoder (over the chunk's
zero-padded frame bucket, as the server runs it); compared are ``mel_gap``
and ``wav_gap``, the widest gaps of the composite mel and of the wav.
Training: ``oracles/train_compare.py``. The model's products a served edit
and a training step: ``edit_flops``, ``train_flops``; its attention calls'
work: ``attention_calls``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import work
from benchmark.oracles.fluentspeech import _bucket, limits, reference_precision
from benchmark.reference import frontend
from benchmark.reference.campnet import CampNet, loss_terms
from benchmark.reference.hifigan import Generator


def reference_model(config: dict, vocab: int) -> CampNet:
    return CampNet(vocab, config["hp"])


def reference_vocoder(config: dict) -> Generator:
    return Generator(config["vocoder"])


@torch.no_grad()
def reference_edits(rows, hp, phones, weights, device, buckets) -> dict:
    model = CampNet(len(phones) + 3, hp).to(device).eval()
    model.load_state_dict({k: v.to(device) for k, v in weights["model"].items()})
    voc = Generator(weights["vocoder_config"]).to(device).eval()
    voc.load_state_dict({k: v.to(device) for k, v in weights["vocoder"].items()})
    t = lambda a: torch.as_tensor(np.asarray(a)).to(device)[None]
    out = {}
    for row in rows:
        item = frontend.prepare(row, hp, phones)
        w0, w1 = item["words_region"][0]
        tm = ((item["mel2word"] >= w0) & (item["mel2word"] <= w1)).astype(np.float32)[:, None]
        mel = t(item["mel"])
        fine = model(t(item["edited_ph_token"]), mel, t(tm))["mel_out_fine"][0]
        comp = fine * t(tm)[0] + mel[0] * (1 - t(tm)[0])
        n = comp.shape[0]
        padded = torch.nn.functional.pad(comp, (0, 0, 0, _bucket(n, buckets) - n))
        wav = voc(padded[None])[0, :n * hp["hop_size"]]
        out[row["item_name"]] = dict(mel=comp.cpu().numpy(), wav=wav.cpu().numpy())
    return out


def gaps(program: dict, reference: dict) -> dict:
    g = dict(mel_gap=0.0, wav_gap=0.0)
    for name, ref in reference.items():
        got = program[name]
        if got["mel_out"].shape != ref["mel"].shape:
            return dict(mel_gap=np.inf, wav_gap=np.inf)
        g["mel_gap"] = max(g["mel_gap"], float(np.abs(got["mel_out"] - ref["mel"]).max()))
        g["wav_gap"] = max(g["wav_gap"], float(np.abs(got["wav_out"] - ref["wav"]).max()))
    return g


def check_served(run, hp, phones, rows, outputs, weights) -> None:
    lim = limits(run)
    if run.device == "cuda":
        reference_precision(tf32=False)
    weights = dict(weights, vocoder_config=run.config["vocoder"])
    ref = reference_edits(rows, hp, phones, weights, run.device,
                          run.mix["server"]["frame_buckets"])
    g = gaps(outputs, ref)
    run.record["gaps"] = g
    for k in ("mel_gap", "wav_gap"):
        run.compare(k, g[k], lim[k])
    run.compare("missing", run.failed, lim.get("missing", 0))
    run.notes.append(f"compared {len(ref)} requests ({', '.join(ref)})")


def control_served(run, hp, phones, rows, weights) -> dict:
    weights = dict(weights, vocoder_config=run.config["vocoder"])
    buckets = run.mix["server"]["frame_buckets"]
    reference_precision(tf32=True)
    low = reference_edits(rows, hp, phones, weights, run.device, buckets)
    reference_precision(tf32=False)
    ref = reference_edits(rows, hp, phones, weights, run.device, buckets)
    return gaps({n: dict(mel_out=o["mel"], wav_out=o["wav"]) for n, o in low.items()}, ref)


def check_train(run, hp, recorded, items, weights, phones) -> None:
    from benchmark.oracles.train_compare import compare_steps

    compare_steps(run, hp, recorded, items, weights, limits(run),
                  lambda: CampNet(hp["vocab_size"], hp), loss_terms)


def control_train(run, hp, items, weights, phones, n_steps: int) -> dict:
    from benchmark.oracles.train_compare import control_gaps

    return control_gaps(run, hp, items, weights, lambda: CampNet(hp["vocab_size"], hp),
                        loss_terms, n_steps)


# -- the model's products (two a multiply-add) -------------------------------------


def campnet_forward(hp: dict, frames: int, tokens: int, frames_sq: int, frames_tokens: int,
                    tokens_sq: int) -> float:
    """CampNet's forward over rows of ``frames`` and ``tokens`` in all, the
    attention's score and value products over each row's real keys
    (``frames_sq`` = sum of T_i^2, ``frames_tokens`` = sum of T_i S_i,
    ``tokens_sq`` = sum of S_i^2): the 3 encoder layers (projections, a
    conv-FFN of kernel ``dec_ffn_kernel_size`` to 4H and back), the 6
    decoder layers (self- and cross-attention, the FFN), the masked-mel
    encoder twice, the five residual conv blocks and the output layers."""
    h, k = hp["hidden_size"], hp["dec_ffn_kernel_size"]
    ffn = 2 * k * h * 4 * h + 2 * 4 * h * h
    enc = tokens * 3 * (8 * h * h + ffn) + 3 * 4 * h * tokens_sq
    dec = (frames * 6 * (8 * h * h + 4 * h * h + ffn) + tokens * 6 * 4 * h * h
           + 6 * 4 * h * (frames_sq + frames_tokens))
    mel_enc = 2 * 2 * (80 * h + 2 * h * h)
    fine = 5 * hp["layers_in_block"] * (2 * 5 * h * 2 * h + 2 * 2 * h * h) + 2 * 3 * h * h
    return enc + dec + frames * (mel_enc + fine + 2 * 2 * h * 80)


def edit_flops(config: dict, frames: int, tokens: int) -> float:
    """A served edit's products: CampNet's forward over the result's
    ``frames`` and the ``tokens`` it reads, and the vocoder."""
    return (campnet_forward(config["hp"], frames, tokens, frames * frames, frames * tokens,
                            tokens * tokens) + frames * work.hifigan_frame(config["vocoder"]))


def train_flops(config: dict, step: dict) -> float:
    """A training step's products over its real rows (forward and backward:
    three times the forward's, no recomputation)."""
    return 3.0 * campnet_forward(config["hp"], step["frames"], step["tokens"],
                                 step["frames_sq"], step["frames_tokens"], step["tokens_sq"])


def attention_calls(hp: dict, step: dict, backward: bool = False) -> tuple[float, float]:
    """(FLOP, bytes) of a CampNet step's nine self-attention calls of K3
    (or K4): three over the tokens, six over the frames, each over the
    rows' real keys; bytes of q, k, v and the output (K4: also the output's
    gradient in, and dq, dk, dv out) and the logsumexp, each once."""
    e = hp["hidden_size"]
    flops = 3 * work.attention(1, e, 1, step["tokens_sq"], backward) \
        + 6 * work.attention(1, e, 1, step["frames_sq"], backward)
    per_row = (8 * e + 2) if backward else (4 * e + 2)
    return flops, 4.0 * per_row * (3 * step["tokens"] + 6 * step["frames"])
