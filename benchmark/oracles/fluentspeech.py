"""How ``correct`` is decided for the ``fluentspeech`` configuration, against
the plain reference (``reference/fluentspeech.py``, ``reference/hifigan.py``,
``reference/frontend.py``), float32 with TF32 off.

Served edits: for a sample of the window's requests, the reference works out
again from the generated request (wav, TextGrid, texts, regions) the front
end, the durations of the edited phones, the splice, the request's noise,
the reverse diffusion, the composite and the vocoder, and three gaps are
compared:

* ``dur_gap``: the widest gap, in frames, between the program's predicted
  durations and the reference's;
* ``mel_gap``: the widest gap between the two composite mels;
* ``wav_gap``: the widest gap between the two wavs (HiFi-GAN is run over the
  chunk's zero-padded frame bucket, as the server runs it).

A duration that rounds to another integer on the two sides is followed as
the program rounded it only when the reference's value lies within
``ROUND_EDGE`` frames of the half (it is counted); any other such duration
fails the request. The reference runs once the window has closed and the
program is freed, one request at a time, at its exact length.

Training: see ``check_train``. The model's products a served edit and a
training step: ``edit_flops``, ``train_flops``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import work
from benchmark.reference import frontend
from benchmark.reference.fluentspeech import FluentSpeech, loss_terms
from benchmark.reference.hifigan import Generator

ROUND_EDGE = 1e-3


def reference_model(config: dict, vocab: int) -> FluentSpeech:
    return FluentSpeech(vocab, config["hp"])


def reference_vocoder(config: dict) -> Generator:
    return Generator(config["vocoder"])


def reference_precision(tf32: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def limits(run) -> dict:
    from benchmark.harness import load_json

    return load_json(f"limits/{run.workload}.json")


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    stride = buckets[-1] - (buckets[-2] if len(buckets) > 1 else 0)
    b = buckets[-1]
    while b < n:
        b += stride
    return b


@torch.no_grad()
def reference_edits(rows, hp, phones, weights, device, seed, buckets, program_dur=None):
    """The reference's result of each request: {name: dict(dur, dur_int,
    mel, wav, replayed)}. ``program_dur`` {name: durations} lets a duration
    at a rounding edge follow the program's rounding."""
    model = FluentSpeech(len(phones) + 3, hp).to(device).eval()
    model.load_state_dict({k: v.to(device) for k, v in weights["model"].items()})
    voc = Generator(weights["vocoder_config"]).to(device).eval()
    voc.load_state_dict({k: v.to(device) for k, v in weights["vocoder"].items()})
    t = lambda a, dt=None: torch.as_tensor(np.asarray(a), dtype=dt).to(device)[None]
    out = {}
    for row in rows:
        item = frontend.prepare(row, hp, phones)
        md, _ = frontend.dur_inputs(item)
        tok = item["edited_ph_token"]
        spk = torch.zeros(1, 256, device=device)
        dur = model.predict_durations(t(tok), t(md), spk)[0].float().cpu().numpy()
        dur_int = np.round(dur.astype(np.float32)).astype(np.int64)
        replayed, broken = 0, False
        if program_dur is not None and row["item_name"] in program_dur:
            prog = np.round(np.asarray(program_dur[row["item_name"]], np.float32)).astype(np.int64)
            if prog.shape != dur_int.shape:
                broken = True
            else:
                for j in np.nonzero(prog != dur_int)[0]:
                    if abs(abs(dur[j] - np.floor(dur[j])) - 0.5) < ROUND_EDGE:
                        dur_int[j] = prog[j]
                        replayed += 1
                    else:
                        broken = True
        m2p, m2w = frontend.regulate(item, dur_int)
        sp = frontend.splice(item, m2p, m2w)
        noise = frontend.request_noise(seed, item, hp["timesteps"], sp["t_new"], device)
        mel = model.sample(t(tok), t(sp["time_mel_masks"]), t(sp["mel2ph"]), spk,
                           t(sp["ref_mels"]), t(sp["f0"]), t(sp["uv"]), noise[:, None])[0]
        tm = t(sp["time_mel_masks"])[0]
        comp = mel * tm + t(sp["ref_mels"])[0] * (1 - tm)
        t_b = _bucket(sp["t_new"], buckets)
        padded = torch.nn.functional.pad(comp, (0, 0, 0, t_b - sp["t_new"]))
        wav = voc(padded[None])[0, :sp["t_new"] * hp["hop_size"]]
        out[row["item_name"]] = dict(dur=dur, dur_int=dur_int, mel=comp.cpu().numpy(),
                                     wav=wav.cpu().numpy(), replayed=replayed, broken=broken)
    return out


def gaps(program: dict, reference: dict) -> dict:
    """The compared numbers over the requests (see the module doc)."""
    g = dict(dur_gap=0.0, mel_gap=0.0, wav_gap=0.0)
    for name, ref in reference.items():
        got = program[name]
        if ref["broken"] or got["mel_out"].shape != ref["mel"].shape:
            return dict(dur_gap=np.inf, mel_gap=np.inf, wav_gap=np.inf)
        if got.get("dur_pred") is not None:
            g["dur_gap"] = max(g["dur_gap"], float(np.abs(got["dur_pred"] - ref["dur"]).max()))
        g["mel_gap"] = max(g["mel_gap"], float(np.abs(got["mel_out"] - ref["mel"]).max()))
        g["wav_gap"] = max(g["wav_gap"], float(np.abs(got["wav_out"] - ref["wav"]).max()))
    return g


def check_served(run, hp, phones, rows, outputs, weights) -> None:
    """Compares the program's ``outputs`` of the sampled ``rows`` with the
    reference's; records each gap beside its limit."""
    lim = limits(run)
    if run.device == "cuda":
        reference_precision(tf32=False)
    weights = dict(weights, vocoder_config=run.config["vocoder"])
    ref = reference_edits(rows, hp, phones, weights, run.device, hp["seed"],
                          run.mix["server"]["frame_buckets"],
                          {n: o["dur_pred"] for n, o in outputs.items()})
    g = gaps(outputs, ref)
    run.record["gaps"] = g
    for k in ("dur_gap", "mel_gap", "wav_gap"):
        run.compare(k, g[k], lim[k])
    run.compare("missing", run.failed, lim.get("missing", 0))
    run.notes.append(f"compared {len(ref)} requests ({', '.join(ref)}); durations followed "
                     f"at a rounding edge: {sum(r['replayed'] for r in ref.values())}")


# -- training ----------------------------------------------------------------------


def sil_ids(phones: list) -> tuple:
    """The ids of the silence phones (and the reserved ids) of a phone set."""
    vocab = frontend.RESERVED + [p for p in phones if p not in frontend.RESERVED]
    return tuple(i for i, p in enumerate(vocab) if frontend.is_sil(p))


def check_train(run, hp, recorded, items, weights, phones) -> None:
    """Follows the program's first steps with the reference and records each
    compared number beside its limit. ``recorded``: the program's losses a
    step, its first gradient (Adam's first moment after one step over 1 -
    beta1) and its parameters after the steps, by name; the reference
    starts from the same seeded weights and draws from a generator seeded
    as the program's."""
    from benchmark.oracles.train_compare import compare_steps

    compare_steps(run, hp, recorded, items, weights, limits(run),
                  lambda: FluentSpeech(hp["vocab_size"], hp),
                  lambda model, batch, gen: loss_terms(model, batch, gen, sil_ids(phones), hp))


def control_served(run, hp, phones, rows, weights) -> dict:
    """The control: the reference in TF32 put in the program's place (its
    durations, composite mel and wav), against the reference in float32,
    over ``rows``."""
    weights = dict(weights, vocoder_config=run.config["vocoder"])
    buckets = run.mix["server"]["frame_buckets"]
    reference_precision(tf32=True)
    low = reference_edits(rows, hp, phones, weights, run.device, hp["seed"], buckets)
    reference_precision(tf32=False)
    ref = reference_edits(rows, hp, phones, weights, run.device, hp["seed"], buckets,
                          {n: o["dur"] for n, o in low.items()})
    program = {n: dict(mel_out=o["mel"], wav_out=o["wav"], dur_pred=o["dur"])
               for n, o in low.items()}
    return gaps(program, ref)


def control_train(run, hp, items, weights, phones, n_steps: int) -> dict:
    from benchmark.oracles.train_compare import control_gaps

    return control_gaps(run, hp, items, weights, lambda: FluentSpeech(hp["vocab_size"], hp),
                        lambda model, batch, gen: loss_terms(model, batch, gen, sil_ids(phones),
                                                             hp), n_steps)


# -- the model's products (two a multiply-add) -------------------------------------


def diffnet_frame(hp: dict) -> float:
    """One DiffNet pass over one frame: the input and output projections,
    the blocks (K1's products and the step's projection are per row, left
    out), the skip projection."""
    c, h, m = hp["residual_channels"], hp["hidden_size"], hp.get("audio_num_mel_bins", 80)
    block = 2 * 2 * c * (3 * c + h + c)
    return 2 * m * c + hp["residual_layers"] * block + 2 * c * c + 2 * c * m


def conditioner_frame(hp: dict) -> float:
    """The conditioner over one frame: the pitch predictor's five convs
    (kernel ``predictor_kernel``, H -> H), the masked-mel encoder's three
    layers (80 -> H, H -> H, H -> H)."""
    h = hp["hidden_size"]
    return 5 * 2 * hp["predictor_kernel"] * h * h + 2 * (80 * h + 2 * h * h)


def conditioner_token(hp: dict) -> float:
    """The text encoder and the duration predictor over one token: each
    encoder block's two convs (H -> 2H, kernel ``enc_kernel_size``; 2H ->
    H), the post conv, the predictor's convs."""
    h, k = hp["hidden_size"], hp["enc_kernel_size"]
    enc = len(hp["enc_dilations"]) * hp["layers_in_block"] * (2 * k * h * 2 * h + 2 * 2 * h * h)
    return enc + 2 * hp["enc_post_net_kernel"] * h * h \
        + hp["dur_predictor_layers"] * 2 * hp["dur_predictor_kernel"] * h * h


def edit_flops(config: dict, frames: int, tokens: int) -> float:
    """A served edit's products: the conditioner over the result's
    ``frames`` and the ``tokens`` it reads, ``timesteps`` DiffNet passes,
    and the vocoder."""
    hp = config["hp"]
    return (frames * (conditioner_frame(hp) + hp["timesteps"] * diffnet_frame(hp)
                      + work.hifigan_frame(config["vocoder"]))
            + tokens * conditioner_token(hp))


def train_flops(config: dict, step: dict) -> float:
    """A training step's products over its real rows (forward and backward:
    three times the forward's, no recomputation): the conditioner and one
    DiffNet pass."""
    hp = config["hp"]
    return 3.0 * (step["frames"] * (conditioner_frame(hp) + diffnet_frame(hp))
                  + step["tokens"] * conditioner_token(hp))
