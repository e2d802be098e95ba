"""Batched region-edit serving: the port of the JAX package's
``infer/serving.py``.

:class:`BatchedEditServer` (FluentSpeech) takes many edit requests at once
(``edit_many``) and runs their device work in batches: duration inpainting
and reverse diffusion, each with the composite and HiFi-GAN chained on the
device. :class:`BatchedInPlaceEditServer` does the same for the in-place
families (CampNet, A3T, EditSpeech, ``infer/editors.py``) with one device
stage. For online traffic, ``infer/online.py::OnlineEditServer`` wraps
either in a ``submit()``/future API and a deadline scheduler over the same
chunk pipeline. Each driver's ``make_server`` builds its family's server.

Design:

* the dynamic work (g2p, region resolution, duration length regulation,
  frame splicing) stays on the host in numpy, with the per-item driver's
  helpers (``infer/spec_denoiser.py``);
* device work runs in chunks of static ``(batch, token bucket, frame
  bucket)`` shapes: requests take the smallest bucket that fits and are
  padded with masks (``mel2ph == 0`` and ``txt == 0`` rows are inert, as in
  training); batch-padding rows replicate a real request and are dropped;
* two batched device programs, duration inpainting and the reverse
  diffusion with the composite and the vocoder chained after it;
* ``warmup()`` runs every (program, batch, bucket) shape once ahead of
  traffic, so the first request into a shape pays none of the first-use
  costs of eager PyTorch (cuDNN's choice of algorithm for HiFi-GAN at the
  shape, the caching allocator's blocks, the build and load of K1).

Determinism: a request's noise comes from its own generator
(``request_generator``: the seed and the request's identity), drawn at the
request's exact frame count (``request_noise``) and zero-padded to the
bucket. So a request's mel depends only on (seed, request, chunk shape):
row index, chunk order and the other requests of its chunk cannot change
it, and at the exact-fit bucket with ``max_batch=1`` it is the per-item
driver's, bit for bit. The padded frames are masked at every reverse step,
so a padded frame bucket changes a real frame only by the float rounding
of the longer convolutions and products. Unlike the JAX package's
threefry keys, whose draw at a padded length extends the exact-fit draw,
torch's generators give no such prefix: drawing at the exact length is
what makes the result independent of the bucket.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from speech_editing_tpu_torch.infer.spec_denoiser import (SpecDenoiserInfer, dur_inpaint_prep,
                                                          dur_to_mel2ph, request_generator,
                                                          request_noise, splice_edit)
from speech_editing_tpu_torch.infer.vocoder import pcm16

def _bucket(n: int, buckets: Sequence[int], multiple: int = 1) -> int:
    """Smallest listed bucket >= n (rounded up to `multiple`); sizes past
    the largest bucket round up to the next multiple of the last stride so
    oversized requests still get a static (cacheable) shape."""
    n = max(int(n), 1)
    for b in buckets:
        b = -(-b // multiple) * multiple
        if n <= b:
            return b
    stride = max(buckets[-1] - (buckets[-2] if len(buckets) > 1 else 0),
                 multiple)
    b = buckets[-1]
    while b < n:
        b += stride
    return -(-b // multiple) * multiple


def _pow2ceil(n: int) -> int:
    """Smallest power of two >= n (adaptive tail-chunk program size)."""
    return 1 << max(n - 1, 0).bit_length()


def _pad_to(arr: np.ndarray, length: int) -> np.ndarray:
    """Zero-pad axis 0 of `arr` to `length`."""
    if arr.shape[0] >= length:
        return arr[:length]
    pad = [(0, length - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


class Request:
    """Mutable per-request record flowing through the serving pipeline.

    The batch server (``edit_many``) and the online scheduler
    (``infer/online.py``) share it: a request is prepared on the host once,
    then advanced through the device stages; ``result`` is set by the final
    stage.
    """

    __slots__ = ("inp", "item", "spk", "prep", "dur_pred", "splice",
                 "gen", "tm", "stage", "group", "result")

    def __init__(self, inp: dict):
        self.inp = inp
        self.item: Optional[dict] = None
        self.spk: Optional[np.ndarray] = None
        self.prep = None          # dur-inpaint inputs
        self.dur_pred: Optional[np.ndarray] = None
        self.splice: Optional[dict] = None
        self.gen: Optional[torch.Generator] = None   # the request's noise generator
        self.tm: Optional[np.ndarray] = None         # in-place families: the frame mask
        self.stage: str = ""
        self.group: Tuple[int, int] = (0, 0)  # (token bucket, frame bucket)
        self.result: Optional[dict] = None


class _ServerBase:
    """Shared bucketing / chunk-planning / warmup machinery."""

    #: device stage names, in pipeline order (subclass sets)
    STAGES: Tuple[str, ...] = ()

    def _init_config(self, hp, max_batch, frame_buckets, token_buckets,
                     frames_batch_budget, adaptive_tail, merge_token_tails):
        self.hp = hp
        self.max_batch = int(max_batch)
        self.frame_buckets = tuple(sorted(frame_buckets))
        self.token_buckets = tuple(sorted(token_buckets))
        # frame buckets must honor frames_multiple: the FastSpeech
        # conditioner clips mel2ph at t//fm*fm (models/fs.py), so a
        # non-multiple bucket would zero conditioning near the edge and
        # silently diverge from the per-item path
        self.fm = int(self.hp.get("frames_multiple", 1))
        # cap batch x frames per device program (0 = no cap): the bucket's
        # batch shrinks to the largest power of two under the budget.
        # Deterministic per bucket, so a request's result depends on its
        # bucket's effective batch only.
        if frames_batch_budget is None:
            frames_batch_budget = int(self.hp.get("serve_frames_batch_budget",
                                                  0))
        self.frames_batch_budget = int(frames_batch_budget)
        # adaptive tail: run a bucket's FINAL partial chunk at the next
        # pow2 >= its real size instead of replicate-padding to the full
        # batch. Opt-in because it relaxes the determinism contract: a
        # request in an adaptive tail runs under a batch size that depends
        # on how many requests co-submitted, and a kernel at another batch
        # size may sum a row in another order (K1's tile plan depends on
        # the batch); never cross-row leakage. Default off = bit-exact
        # batch-composition invariance.
        if adaptive_tail is None:
            adaptive_tail = bool(self.hp.get("serve_adaptive_tail", False))
        self.adaptive_tail = bool(adaptive_tail)
        # cross-token-bucket tail packing: leftover partial chunks of
        # DIFFERENT token buckets at the SAME frame bucket merge into one
        # chunk run at the members' max token bucket (token-bucket padding
        # is numerically inert for the diffusion family, asserted in
        # tests/test_torch_serving.py, so the drift bound is the same
        # reassociation band as adaptive_tail). Opt-in for the same
        # contract reason.
        if merge_token_tails is None:
            merge_token_tails = bool(self.hp.get("serve_merge_token_tails",
                                                 False))
        self.merge_token_tails = bool(merge_token_tails)
        # result fetch size: serve_wav_int16 runs save_wav's exact PCM
        # conversion (clip*32767 -> trunc int16) on the device and fetches
        # 2-byte samples, bit-identical to the wav file the f32 path
        # writes. serve_fetch_mel: "f32" (default, bit-exact results),
        # "f16" (half the mel fetch bytes), "off" (no composite fetch;
        # result carries mel_out=None: the serve CLI only writes wavs).
        # Both apply on the host-vocoder (Griffin-Lim) path too.
        self.wav_int16 = bool(self.hp.get("serve_wav_int16", False))
        self.fetch_mel = str(self.hp.get("serve_fetch_mel", "f32"))
        if self.fetch_mel not in ("f32", "f16", "off"):
            raise ValueError(f"serve_fetch_mel: {self.fetch_mel!r} is not f32, f16 or off")
        # program-shape log: every device-program launch records
        # (program name, arg shapes); "no new entries after warmup()" ==
        # "traffic met no shape warmup did not run first"
        # (asserted in tests/test_torch_serving.py).
        self.program_shapes: set = set()

    # -- bucketing ------------------------------------------------------------
    def _fb(self, n: int) -> int:
        return _bucket(n, self.frame_buckets, self.fm)

    def _tb(self, n: int) -> int:
        return _bucket(n, self.token_buckets)

    def _mb(self, t_b: int) -> int:
        """Effective batch for a frame bucket under the budget, floored to
        a power of two."""
        if self.frames_batch_budget <= 0:
            return self.max_batch
        mb = max(1, min(self.max_batch, self.frames_batch_budget // t_b))
        return 1 << (mb.bit_length() - 1)

    def _chunks(self, idxs: List[int], t_b: Optional[int] = None):
        mb = self._mb(t_b) if t_b else self.max_batch
        for i in range(0, len(idxs), mb):
            chunk = idxs[i: i + mb]
            if self.adaptive_tail and len(chunk) < mb:
                yield chunk, _pow2ceil(len(chunk))
            else:
                yield chunk, mb

    def _plan_chunks(self, groups: Dict[Tuple[int, int], list]
                     ) -> List[Tuple[int, int, list, int]]:
        """Chunk plan for a set of bucketed requests: list of
        ``(token_bucket, frame_bucket, members, effective_batch)``.

        Without ``merge_token_tails`` this reproduces the per-group
        chunking exactly (full chunks + one tail per (s_b, t_b) group).
        With it, each frame bucket's leftover tails from different token
        buckets pack into shared chunks at the members' max token bucket.
        """
        plan: List[Tuple[int, int, list, int]] = []
        if not self.merge_token_tails:
            for (s_b, t_b), members in sorted(groups.items()):
                for chunk, b_eff in self._chunks(members, t_b):
                    plan.append((s_b, t_b, chunk, b_eff))
            return plan
        tails: Dict[int, list] = {}
        for (s_b, t_b), members in sorted(groups.items()):
            mb = self._mb(t_b)
            n_full = len(members) // mb * mb
            for i in range(0, n_full, mb):
                plan.append((s_b, t_b, members[i: i + mb], mb))
            if n_full < len(members):
                tails.setdefault(t_b, []).append((s_b, members[n_full:]))
        for t_b, parts in sorted(tails.items()):
            mb = self._mb(t_b)
            flat = [(s_b, m) for s_b, ms in parts for m in ms]
            for i in range(0, len(flat), mb):
                chunk = flat[i: i + mb]
                s_b = max(s for s, _ in chunk)
                members = [m for _, m in chunk]
                b_eff = (_pow2ceil(len(chunk))
                         if self.adaptive_tail and len(chunk) < mb else mb)
                plan.append((s_b, t_b, members, b_eff))
        return plan

    def _record(self, program: str, *arrays) -> None:
        self.program_shapes.add(
            (program, tuple((tuple(a.shape), str(a.dtype))
                            for a in arrays)))

    def _wav_out(self, wavs: torch.Tensor) -> np.ndarray:
        """The chunk's wavs on the host, as 16-bit PCM under
        ``serve_wav_int16`` (converted where they are, then fetched)."""
        return (pcm16(wavs) if self.wav_int16 else wavs).cpu().numpy()

    def _mel_out(self, comp: torch.Tensor) -> Optional[np.ndarray]:
        """The composite mel on the host per ``serve_fetch_mel``: f32
        (bit-exact default), f16 (half the bytes), or None for "off"."""
        if self.fetch_mel == "off":
            return None
        return comp.to(torch.float16 if self.fetch_mel == "f16" else torch.float32).cpu().numpy()

    def _warm_batches(self, t_b: int) -> List[int]:
        """Batch sizes traffic can produce at a frame bucket: the budgeted
        full batch, plus the whole pow2 tail ladder when adaptive."""
        mb = self._mb(t_b)
        if not self.adaptive_tail:
            return [mb]
        out, b = [], 1
        while b < mb:
            out.append(b)
            b <<= 1
        out.append(mb)
        return out

    def warmup(self, frame_buckets: Optional[Sequence[int]] = None,
               token_buckets: Optional[Sequence[int]] = None,
               batches: Optional[Sequence[int]] = None,
               pairs: Optional[Sequence[Tuple[int, int]]] = None,
               verbose: bool = False, workers: int = 1) -> int:
        """Run every (program, batch, bucket) shape once ahead of traffic.

        Runs each device stage (and the batched vocoder) on synthetic
        inputs at every combination of ``frame_buckets x token_buckets x
        batches`` — by default the server's full bucket sets and, per
        frame bucket, the budgeted batch plus the adaptive-tail pow2
        ladder. ``pairs`` = explicit ``(token_bucket, frame_bucket)``
        pairs instead of the cross product (real traffic usually occupies
        a thin diagonal: token count tracks utterance length). ``workers``
        threads run the shapes concurrently. Returns the number of
        distinct program shapes warmed.
        """
        if pairs is None:
            frame_buckets = tuple(frame_buckets or self.frame_buckets)
            token_buckets = tuple(token_buckets or self.token_buckets)
            pairs = [(s_b, t_b) for t_b in frame_buckets
                     for s_b in token_buckets]
        n0 = len(self.program_shapes)
        shapes = []
        for s_b, t_b in pairs:
            t_b = -(-t_b // self.fm) * self.fm
            for b in (batches or self._warm_batches(t_b)):
                shapes.append((int(b), int(s_b), int(t_b)))
        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=workers) as ex:
                for (b, s_b, t_b), f in [(sh, ex.submit(
                        self._warm_shape, *sh)) for sh in shapes]:
                    f.result()
                    if verbose:
                        print(f"| warmup: B={b} T={t_b} S={s_b}", flush=True)
        else:
            for b, s_b, t_b in shapes:
                if verbose:
                    print(f"| warmup: B={b} T={t_b} S={s_b}", flush=True)
                self._warm_shape(b, s_b, t_b)
        return len(self.program_shapes) - n0

    def _warm_shape(self, b: int, s_b: int, t_b: int) -> None:
        raise NotImplementedError

    # -- online scheduler hooks (infer/online.py) -----------------------------
    def online_prepare(self, inp: dict, seed: Optional[int]) -> Request:
        raise NotImplementedError

    def online_run(self, stage: str, s_b: int, t_b: int,
                   reqs: List[Request], b_eff: int) -> None:
        raise NotImplementedError


class BatchedEditServer(_ServerBase):
    """Batched FluentSpeech region-edit server.

    Wraps a ``SpecDenoiserInfer`` (model, vocoder and speaker embedder are
    built once; without one, it builds one from ``hp`` on ``device``, by
    default the GPU, which raises when there is none); ``edit_many`` takes
    a list of raw request dicts (same schema as ``infer_once``) and returns
    one result dict per request, running the device work in batches.

    Pipeline stages (``Request.stage``): ``"dur"`` — batched duration
    inpainting per (token bucket, frame bucket of the ORIGINAL length);
    host splice; ``"diff"`` — batched reverse diffusion + composite +
    vocode per (token bucket, frame bucket of the EDITED length).
    """

    STAGES = ("dur", "diff")

    def __init__(self, infer_ins: Optional[SpecDenoiserInfer] = None,
                 hp: Optional[Any] = None, max_batch: int = 8,
                 frame_buckets: Sequence[int] = (128, 256, 512, 1024, 1536),
                 token_buckets: Sequence[int] = (32, 64, 128, 256),
                 frames_batch_budget: Optional[int] = None,
                 adaptive_tail: Optional[bool] = None,
                 merge_token_tails: Optional[bool] = None,
                 device: Any = "cuda"):
        if infer_ins is None and hp is None:
            raise ValueError("BatchedEditServer: pass a SpecDenoiserInfer or its hp")
        self.infer = infer_ins or SpecDenoiserInfer(hp, device)
        self._init_config(self.infer.hp, max_batch, frame_buckets,
                          token_buckets, frames_batch_budget, adaptive_tail,
                          merge_token_tails)

    # -- per-chunk pipeline ---------------------------------------------------
    def prepare(self, inp: dict, seed: int) -> Request:
        """Host stage: preprocess + spk embedding + dur-inpaint inputs +
        the request's noise generator; enters the ``dur`` stage bucketed
        by (edited tokens, ORIGINAL frame count)."""
        r = Request(inp)
        r.item = self.infer.preprocess_input(inp)
        r.spk = self.infer.spk_embedder(r.item["wav"])
        r.prep = dur_inpaint_prep(r.item)
        r.gen = request_generator(seed, r.item, self.infer.device)
        r.stage = "dur"
        r.group = (self._tb(len(r.item["edited_ph_token"])),
                   self._fb(len(r.item["mel2ph"])))
        return r

    def run_dur_chunk(self, reqs: List[Request], s_b: int, t_b: int,
                      b_eff: int) -> None:
        """Device stage 1: batched duration inpainting; fills
        ``r.dur_pred`` then advances each request to the ``diff`` stage
        (host splice happens in ``_advance_to_diff``)."""
        rows = reqs + [reqs[0]] * (b_eff - len(reqs))
        txt = np.stack([_pad_to(r.item["edited_ph_token"], s_b)
                        for r in rows])
        tm = np.stack([_pad_to(r.prep[2].astype(np.float32), t_b)
                       for r in rows])[:, :, None]
        m2p = np.stack([_pad_to(r.prep[1], t_b) for r in rows])
        mdur = np.stack([_pad_to(r.prep[0], s_b) for r in rows])
        spk = np.stack([r.spk for r in rows])
        self._record("dur", txt, tm, m2p, mdur, spk)
        d = self.infer._predict_dur(txt, tm, m2p, mdur, spk).float().cpu().numpy()
        for i, r in enumerate(reqs):
            r.dur_pred = d[i, :len(r.item["edited_ph_token"])]
            self._advance_to_diff(r)

    def _advance_to_diff(self, r: Request) -> None:
        """Host stage: length-regulate + splice; re-bucket by the EDITED
        frame count for the diffusion stage."""
        m2p_pred, m2w_pred = dur_to_mel2ph(r.item, r.dur_pred, self.fm)
        r.splice = splice_edit(r.item, m2p_pred, m2w_pred, self.fm)
        r.stage = "diff"
        r.group = (self._tb(len(r.item["edited_ph_token"])),
                   self._fb(r.splice["t_new"]))

    def chunk_noise(self, reqs: List[Request], t_b: int, b_eff: int) -> torch.Tensor:
        """The chunk's noise [timesteps + 1, b_eff, t_b, 80]: each request's
        ``request_noise`` at its own frame count, zero-padded to ``t_b``;
        batch-padding rows repeat the first request's. (A test replaces it
        to replay another run's draws.)"""
        model = self.infer.model
        rows = [F.pad(request_noise(r.gen, model.num_timesteps, r.splice["t_new"],
                                    model.out_dims), (0, 0, 0, t_b - r.splice["t_new"]))
                for r in reqs]
        return torch.stack(rows + rows[:1] * (b_eff - len(reqs)), dim=1)

    def run_diff_chunk(self, reqs: List[Request], s_b: int, t_b: int,
                       b_eff: int) -> None:
        """Device stage 2: batched reverse diffusion + composite + vocode;
        sets ``r.result``."""
        rows = reqs + [reqs[0]] * (b_eff - len(reqs))
        txt = np.stack([_pad_to(r.item["edited_ph_token"], s_b)
                        for r in rows])
        tm = np.stack([_pad_to(r.splice["time_mel_masks"], t_b)
                       for r in rows])
        m2p = np.stack([_pad_to(r.splice["mel2ph"], t_b) for r in rows])
        ref = np.stack([_pad_to(r.splice["ref_mels"], t_b) for r in rows])
        f0 = np.stack([_pad_to(r.splice["f0"], t_b) for r in rows])
        uv = np.stack([_pad_to(r.splice["uv"], t_b) for r in rows])
        spk = np.stack([r.spk for r in rows])
        noise = self.chunk_noise(reqs, t_b, b_eff)
        self._record("diff", txt, tm, m2p, spk, ref, f0, uv)
        # tm and ref go to the device once, for the program and the composite
        tm_d, ref_d = self.infer._tensor(tm), self.infer._tensor(ref)
        mel_out = self.infer._infer(txt, tm_d, m2p, spk, ref_d, f0, uv, noise)
        # the composite on the device (elementwise, so bit-identical to the
        # per-item driver's numpy composite) chained into the vocoder
        comp = mel_out * tm_d + ref_d * (1 - tm_d)
        vocoder = self.infer.vocoder
        if vocoder.device_batched:
            self._record("vocoder", comp)
            wavs = self._wav_out(vocoder.spec2wav_batch_dev(comp))
        else:    # a host vocoder: only the real rows
            wavs = vocoder.spec2wav_batch(comp[:len(reqs)].cpu().numpy())
            if self.wav_int16:
                wavs = pcm16(torch.from_numpy(np.asarray(wavs))).numpy()
        comp = self._mel_out(comp)
        hop = int(self.hp["hop_size"])
        for i, r in enumerate(reqs):
            t_new = r.splice["t_new"]
            r.result = {
                "mel_out": None if comp is None else comp[i, :t_new],
                "wav_out": np.asarray(wavs[i][:t_new * hop]),
                "t_frames": t_new,
                "time_mel_masks": r.splice["time_mel_masks"],
                "ref_mels": r.splice["ref_mels"],
            }

    # -- online scheduler hooks -----------------------------------------------
    def _seed(self, seed: Optional[int]) -> int:
        return int(self.hp.get("seed", 1234)) if seed is None else int(seed)

    def online_prepare(self, inp: dict, seed: Optional[int]) -> Request:
        return self.prepare(inp, self._seed(seed))

    def online_run(self, stage: str, s_b: int, t_b: int,
                   reqs: List[Request], b_eff: int) -> None:
        if stage == "dur":
            self.run_dur_chunk(reqs, s_b, t_b, b_eff)
        else:
            self.run_diff_chunk(reqs, s_b, t_b, b_eff)

    # -- warmup ---------------------------------------------------------------
    def _warm_shape(self, b: int, s_b: int, t_b: int) -> None:
        r = _synthetic_dur_request(s_b, t_b, request_generator(0, {}, self.infer.device))
        # stage 1 program (dur inpainting). _advance_to_diff rebuckets the
        # synthetic request by its own predicted length; discard that and
        # warm the diff stage at the requested bucket explicitly.
        self.run_dur_chunk([r], s_b, t_b, b)
        r.splice = _synthetic_splice(s_b, t_b)
        self.run_diff_chunk([r], s_b, t_b, b)

    # -- batch driver ---------------------------------------------------------
    def edit_many(self, inputs: List[dict], seed: Optional[int] = None
                  ) -> List[dict]:
        if not inputs:
            return []
        seed = self._seed(seed)
        reqs = [self.prepare(inp, seed) for inp in inputs]

        groups: Dict[Tuple[int, int], list] = {}
        for r in reqs:
            groups.setdefault(r.group, []).append(r)
        for s_b, t_b, members, b_eff in self._plan_chunks(groups):
            self.run_dur_chunk(members, s_b, t_b, b_eff)

        groups = {}
        for r in reqs:
            groups.setdefault(r.group, []).append(r)
        for s_b, t_b, members, b_eff in self._plan_chunks(groups):
            self.run_diff_chunk(members, s_b, t_b, b_eff)
        return [r.result for r in reqs]  # type: ignore[return-value]


def _synthetic_dur_request(s_b: int, t_b: int, gen: torch.Generator) -> Request:
    """Shape-only request for warmup: values are inert (mel2ph=1 keeps
    gathers in range), only the array shapes/dtypes matter."""
    r = Request({})
    r.item = {"edited_ph_token": np.ones(s_b, np.int64)}
    r.spk = np.zeros(256, np.float32)
    r.prep = (np.ones(s_b, np.int64), np.ones(t_b, np.int64),
              np.zeros(t_b, bool))
    r.gen = gen
    r.stage = "dur"
    r.group = (s_b, t_b)
    # _advance_to_diff needs these to not crash; its result is discarded
    r.item.update(edited_ph2word=np.ones(s_b, np.int64),
                  ph2word=np.ones(s_b, np.int64),
                  mel2ph=np.ones(t_b, np.int64),
                  mel2word=np.ones(t_b, np.int64),
                  dur=np.ones(s_b, np.int64),
                  f0=np.zeros(t_b, np.float32),
                  uv=np.zeros(t_b, np.float32),
                  mel=np.zeros((t_b, 80), np.float32),
                  words_region=[(1, 1)], edited_words_region=[(1, 1)])
    return r


def _synthetic_splice(s_b: int, t_b: int) -> dict:
    return {"mel2ph": np.ones(t_b, np.int64),
            "ref_mels": np.zeros((t_b, 80), np.float32),
            "f0": np.zeros(t_b, np.float32),
            "uv": np.zeros(t_b, np.float32),
            "time_mel_masks": np.zeros((t_b, 1), np.float32),
            "t_new": t_b}


class BatchedInPlaceEditServer(_ServerBase):
    """Batched serving for the in-place editing families (CampNet, A3T,
    EditSpeech: ``infer/editors.py``).

    These models keep the source's frame grid and regenerate the masked
    span with one deterministic forward (no duration inpainting, no
    diffusion, no noise), so a chunk of static ``(batch, token bucket,
    frame bucket)`` shape is one device stage: the family's
    ``_model_mel_out_batch``, the composite on the device, and the vocoder
    chained after it. Batch-padding rows replicate a real request and are
    dropped; a chunk is always padded to its bucket's batch.

    Determinism: every family computes row by row and draws nothing, so a
    request's result depends only on (request, token bucket, frame bucket,
    batch): row placement, chunk order and the co-batched requests change
    nothing, bit for bit, and at ``max_batch`` 1 and the exact-fit bucket
    it is the per-item driver's. Bucket padding, by family:

    * CampNet masks padded tokens and frames at the attention keys and its
      conv and norm stacks re-mask, so padding is inert up to the float
      rounding of the longer shapes;
    * EditSpeech scans its backward LSTM from each row's true end and its
      other paths are causal or pointwise: inert the same way;
    * A3T depends on the bucket unless ``serve_pad_safe_a3t`` is set:
      frame padding sits between the mel and the text segments, shifting
      their relative positions, and the conformer conv is unmasked (as the
      reference). The result is still deterministic per (bucket, batch).
      Under the flag, padding moves to the end of the joint sequence and is
      inert as for the other two; at exact fit the flag changes nothing.
    """

    STAGES = ("fwd",)

    def __init__(self, infer_ins, max_batch: int = 8,
                 frame_buckets: Sequence[int] = (128, 256, 512, 1024, 1536),
                 token_buckets: Sequence[int] = (32, 64, 128, 256),
                 frames_batch_budget: Optional[int] = None,
                 adaptive_tail: Optional[bool] = None,
                 merge_token_tails: Optional[bool] = None):
        self.infer = infer_ins
        self._init_config(infer_ins.hp, max_batch, frame_buckets, token_buckets,
                          frames_batch_budget, adaptive_tail, merge_token_tails)

    # -- per-chunk pipeline ---------------------------------------------------
    def prepare(self, inp: dict) -> Request:
        """Host stage: preprocess, speaker embedding, the frame mask; bucketed
        by (the family's tokens, frames)."""
        r = Request(inp)
        r.item = self.infer.preprocess_input(inp)
        r.spk = self.infer.spk_embedder(r.item["wav"])
        r.tm = self.infer._frame_mask(r.item)[:, None]
        r.stage = "fwd"
        r.group = (self._tb(len(r.item[self.infer._token_field])),
                   self._fb(len(r.item["mel"])))
        return r

    def run_fwd_chunk(self, reqs: List[Request], s_b: int, t_b: int, b_eff: int) -> None:
        """The device stage: the batched model forward, the composite and
        the vocoder; sets ``r.result``."""
        tok_field = self.infer._token_field
        rows = reqs + [reqs[0]] * (b_eff - len(reqs))
        txt = np.stack([_pad_to(r.item[tok_field], s_b) for r in rows])
        mels = np.stack([_pad_to(r.item["mel"], t_b) for r in rows])
        m2p = np.stack([_pad_to(r.item["mel2ph"], t_b) for r in rows])
        tm = np.stack([_pad_to(r.tm, t_b) for r in rows])
        f0 = np.stack([_pad_to(r.item["f0"], t_b) for r in rows])
        uv = np.stack([_pad_to(r.item["uv"], t_b) for r in rows])
        spk = np.stack([r.spk for r in rows])
        self._record("fwd", txt, mels, m2p, tm, spk, f0, uv)
        # tm and mels go to the device once, for the program and the composite
        tm_d, mels_d = self.infer._tensor(tm), self.infer._tensor(mels)
        mel_out = self.infer._model_mel_out_batch(txt, mels_d, m2p, tm_d, spk, f0, uv)
        comp = mel_out * tm_d + mels_d * (1 - tm_d)
        vocoder = self.infer.vocoder
        if vocoder.device_batched:
            self._record("vocoder", comp)
            wavs = self._wav_out(vocoder.spec2wav_batch_dev(comp))
        else:    # a host vocoder: only the real rows
            wavs = vocoder.spec2wav_batch(comp[:len(reqs)].cpu().numpy())
            if self.wav_int16:
                wavs = pcm16(torch.from_numpy(np.asarray(wavs))).numpy()
        comp = self._mel_out(comp)
        hop = int(self.hp["hop_size"])
        for i, r in enumerate(reqs):
            t_i = len(r.item["mel"])
            r.result = {
                "mel_out": None if comp is None else comp[i, :t_i],
                "wav_out": np.asarray(wavs[i][:t_i * hop]),
                "t_frames": t_i,
                "time_mel_masks": r.tm,
                "ref_mels": r.item["mel"],
            }

    # -- online scheduler hooks -----------------------------------------------
    def online_prepare(self, inp: dict, seed: Optional[int]) -> Request:
        del seed  # deterministic families
        return self.prepare(inp)

    def online_run(self, stage: str, s_b: int, t_b: int,
                   reqs: List[Request], b_eff: int) -> None:
        if stage != "fwd":
            raise ValueError(f"BatchedInPlaceEditServer: no stage {stage!r}")
        self.run_fwd_chunk(reqs, s_b, t_b, b_eff)

    # -- warmup ---------------------------------------------------------------
    def _warm_shape(self, b: int, s_b: int, t_b: int) -> None:
        r = Request({})
        r.item = {self.infer._token_field: np.ones(s_b, np.int64),
                  "mel": np.zeros((t_b, 80), np.float32),
                  "mel2ph": np.ones(t_b, np.int64),
                  "f0": np.zeros(t_b, np.float32),
                  "uv": np.zeros(t_b, np.float32)}
        r.spk = np.zeros(256, np.float32)
        r.tm = np.zeros((t_b, 1), np.float32)
        self.run_fwd_chunk([r], s_b, t_b, b)

    # -- batch driver ---------------------------------------------------------
    def edit_many(self, inputs: List[dict], seed: Optional[int] = None) -> List[dict]:
        """One result dict per request; ``seed`` is accepted for the API of
        :class:`BatchedEditServer` and unused (nothing is drawn)."""
        del seed
        if not inputs:
            return []
        reqs = [self.prepare(inp) for inp in inputs]
        groups: Dict[Tuple[int, int], list] = {}
        for r in reqs:
            groups.setdefault(r.group, []).append(r)
        for s_b, t_b, members, b_eff in self._plan_chunks(groups):
            self.run_fwd_chunk(members, s_b, t_b, b_eff)
        return [r.result for r in reqs]  # type: ignore[return-value]
