"""PyTorch port, the in-place editing families' drivers
(``infer/editors.py``) and their batch server
(``infer/serving.py::BatchedInPlaceEditServer``), against the JAX package's
and on the port's own serving contract.

Both packages load the same tiny JAX checkpoint of each family (flax's init
with every bias perturbed, ``tests/test_serving.py::inplace_env``). Whole
edits through ``CampNetInfer``, ``A3TInfer`` and ``EditSpeechInfer`` give
JAX's mel within 1e-3, and so does an int8 EditSpeech edit (its LSTM
weights swapped in dequantized). ``quantize`` equals JAX's ``quantize_tree``
leaf for leaf for the three families. On the port alone, as the JAX
package's ``tests/test_serving.py`` holds its server: at ``max_batch`` 1
and the exact-fit bucket the server gives the per-item driver's mel bit for
bit; a request's mel is bit-identical whatever its row and co-batched
requests; bucket padding is inert for CampNet, for EditSpeech and for A3T
under ``serve_pad_safe_a3t`` (and deterministic for A3T without it).
``example_run`` with ``serve_batched``, the CSV command line
(``python -m speech_editing_tpu_torch.infer.editors``), the serve CLI and
the online scheduler route the families.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import speech_editing_tpu.infer.editors as jeditors
import speech_editing_tpu_torch.infer.editors as peditors
from speech_editing_tpu.infer.quant import _is_qleaf, _QKEY, _SKEY, quantize_tree
from speech_editing_tpu.training.checkpoint import get_last_checkpoint, load_checkpoint
from speech_editing_tpu_torch.config.hparams import dump_yaml
from speech_editing_tpu_torch.infer.online import OnlineEditServer
from speech_editing_tpu_torch.infer.quant import QLeaf, channel_views, quantize
from speech_editing_tpu_torch.infer.serve import _load_request
from speech_editing_tpu_torch.infer.serve import main as serve_main
from speech_editing_tpu_torch.infer.serving import BatchedInPlaceEditServer
from speech_editing_tpu_torch.utils import convert_jax_params as cjp
from speech_editing_tpu_torch.utils.audio.io import load_wav, save_wav
from tests.test_serving import INPLACE_FAMILIES, REQ_A, REQ_B, REQ_C, _make_request
from tests.test_serving import inplace_env  # noqa: F401  (a fixture)
from tests.test_torch_infer_frontend import write_textgrid
from tests.test_torch_serving import write_vocoder
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

FAMILIES = [name for _, name in INPLACE_FAMILIES]
TASKS = dict((name, task) for task, name in INPLACE_FAMILIES)
CONVERTERS = {"CampNetInfer": cjp.campnet_params_from_jax, "A3TInfer": cjp.a3t_params_from_jax,
              "EditSpeechInfer": cjp.editspeech_params_from_jax}
JAX_TOL = dict(atol=1e-3, rtol=1e-3)
PAD_TOL = dict(atol=2e-5, rtol=0)      # JAX's bound for a padded bucket against exact fit
SR = 22050


@pytest.fixture(scope="module")
def env(inplace_env, tmp_path_factory):  # noqa: F811
    """Per family: the JAX checkpoint's hp, the port's driver on the CPU
    (a tiny HiFi-GAN: the device-batched vocoder path) and JAX's driver."""
    voc = write_vocoder(tmp_path_factory.mktemp("inplace_voc"))
    cache = {}

    def get(name):
        if name not in cache:
            hp = inplace_env(TASKS[name], name)
            port_hp = dict(hp, vocoder="HifiGAN", vocoder_ckpt=voc, task_cls=TASKS[name])
            cache[name] = dict(hp=hp, port_hp=port_hp,
                               port=getattr(peditors, name)(port_hp, device="cpu"))
        return cache[name]
    return get


def _serve(infer_ins, reqs, t_b, s_b, max_batch=2):
    return infer_ins.make_server(infer_ins, max_batch=max_batch, frame_buckets=(t_b,),
                                 token_buckets=(s_b,)).edit_many(reqs)


def _fit(infer_ins, req=REQ_A):
    item = infer_ins.preprocess_input(_make_request(**req))
    return len(item["mel"]), len(item[infer_ins._token_field])


@pytest.mark.parametrize("name", FAMILIES)
def test_driver_edit_matches_jax(env, name):
    e = env(name)
    j = getattr(jeditors, name)(e["hp"])
    inp = _make_request(**REQ_A)
    ref = j.forward_model(j.preprocess_input(inp))
    got = e["port"].forward_model(e["port"].preprocess_input(inp))
    np.testing.assert_allclose(got[2], ref[2], **JAX_TOL)      # mel_out
    tm = got[4] != 0
    assert tm.any() and np.array_equal(got[2][~tm.any(1)], inp["mel"][~tm.any(1)])


def test_int8_editspeech_matches_jax(env):
    e = env("EditSpeechInfer")
    hp8 = dict(e["hp"], serve_quant_int8=True, quant_min_size=512)
    j = jeditors.EditSpeechInfer(hp8)
    port = peditors.EditSpeechInfer(dict(e["port_hp"], **hp8), device="cpu")
    assert port.quant is not None and any("lstm" in n for n in port.quant.qstate)
    inp = _make_request(**REQ_A)
    ref = j.forward_model(j.preprocess_input(inp))[2]
    np.testing.assert_allclose(port.forward_model(port.preprocess_input(inp))[2], ref, **JAX_TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_quantize_equals_jax_leaf_for_leaf(env, name):
    e = env(name)
    hp, model = e["hp"], e["port"].model
    jp = jax.tree.map(np.array, load_checkpoint(get_last_checkpoint(hp["work_dir"])[0])["state"]
                      .params)
    min_size = 512
    jq = quantize_tree(jp, min_size=min_size)
    views = channel_views(model)
    q = quantize(model.state_dict(), views, min_size)

    def mapped(fn):
        return CONVERTERS[name](jax.tree.map(fn, jq, jp, is_leaf=_is_qleaf), hp)
    flags = mapped(lambda ql, p: np.full(p.shape, float(_is_qleaf(ql)), np.float32))
    values = mapped(lambda ql, p: ql[_QKEY].astype(np.float32) if _is_qleaf(ql)
                    else np.zeros(p.shape, np.float32))
    scales = mapped(lambda ql, p: np.broadcast_to(ql[_SKEY], p.shape).astype(np.float32)
                    if _is_qleaf(ql) else np.zeros(p.shape, np.float32))
    # EditSpeech's dur_embed is not in the flax tree (never called): zero here
    absent = {"fs.dur_embed.weight"} if name == "EditSpeechInfer" else set()
    n_quantized = 0     # flax kernels: a packed weight holds views[key].leaves of them
    for key, leaf in q.items():
        if key in absent:
            continue
        assert isinstance(leaf, QLeaf) == bool(flags[key].all()), key
        if isinstance(leaf, QLeaf):
            n_quantized += views[key].leaves
            torch.testing.assert_close(leaf.q8.reshape(leaf.shape).float(), values[key],
                                       atol=0, rtol=0)
            torch.testing.assert_close(leaf.scale.expand(leaf.q8.shape).reshape(leaf.shape),
                                       scales[key], atol=0, rtol=0)
    assert n_quantized == sum(_is_qleaf(x) for x in jax.tree.leaves(jq, is_leaf=_is_qleaf))
    assert n_quantized >= 10


@pytest.mark.parametrize("name", FAMILIES)
def test_exact_fit_server_equals_the_per_item_driver(env, name):
    port = env(name)["port"]
    t_fit, s_fit = _fit(port)
    res = _serve(port, [_make_request(**REQ_A)], t_fit, s_fit, max_batch=1)[0]
    per_item = port.forward_model(port.preprocess_input(_make_request(**REQ_A)))
    np.testing.assert_array_equal(res["mel_out"], per_item[2])
    np.testing.assert_array_equal(res["wav_out"], per_item[0])


@pytest.mark.parametrize("name", FAMILIES)
def test_row_and_co_batched_requests_change_nothing(env, name):
    """At a padded bucket (A3T's depends on it, deterministically): alone
    at row 0, or at row 1 behind another request, the same bits."""
    port = env(name)["port"]
    t_fit, s_fit = _fit(port)
    alone = _serve(port, [_make_request(**REQ_A)], t_fit + 16, s_fit + 8)[0]["mel_out"]
    at_row_1 = _serve(port, [_make_request(**REQ_B), _make_request(**REQ_A)],
                      t_fit + 16, s_fit + 8)[1]["mel_out"]
    np.testing.assert_array_equal(at_row_1, alone)


@pytest.mark.parametrize("name,pad_safe", [("CampNetInfer", False), ("EditSpeechInfer", False),
                                           ("A3TInfer", True)])
def test_padded_buckets_are_inert(env, name, pad_safe):
    e = env(name)
    port = e["port"]
    if pad_safe:
        port = peditors.A3TInfer(dict(e["port_hp"], serve_pad_safe_a3t=True), device="cpu")
    t_fit, s_fit = _fit(port)
    exact = _serve(port, [_make_request(**REQ_A)], t_fit, s_fit)[0]["mel_out"]
    padded = _serve(port, [_make_request(**REQ_A)], t_fit + 16, s_fit + 8)[0]["mel_out"]
    np.testing.assert_allclose(padded, exact, **PAD_TOL)
    if pad_safe:     # a no-op at exact fit
        off = _serve(e["port"], [_make_request(**REQ_A)], t_fit, s_fit)[0]["mel_out"]
        np.testing.assert_allclose(exact, off, **PAD_TOL)


def _rows(tmp_path, n_frames=40, names=("inplace_0", "inplace_1")):
    """CSV/JSONL rows of a harmonic wav, each with a TextGrid and a mel2ph."""
    from speech_editing_tpu_torch.utils.text.processors import get_txt_processor_cls, txt_to_ph

    hop = 256
    wav = (0.3 * np.sin(2 * np.pi * 150 * np.arange(n_frames * hop) / SR)).astype(np.float32)
    wav_fn = str(tmp_path / "src.wav")
    save_wav(wav, wav_fn, SR)
    ph, *_ = txt_to_ph(get_txt_processor_cls("en"), "this is a test sentence")
    s = len(ph.split(" "))
    mel2ph = np.minimum(np.arange(n_frames) * s // n_frames + 1, s)
    rows = []
    for name in names:
        tg = str(tmp_path / f"{name}.TextGrid")
        write_textgrid(tg, "this is a test sentence", n_frames)
        rows.append({"item_name": name, "text": "this is a test sentence",
                     "edited_text": "this is a wonderful test sentence", "region": "[3,4]",
                     "edited_region": "[3,5]", "wav_fn_orig": wav_fn, "mfa_textgrid": tg,
                     "mel2ph": [int(m) for m in mel2ph]})
    return rows


def test_example_run_serve_batched(env, tmp_path):
    hp = dict(env("CampNetInfer")["port_hp"], serve_batched=True, serve_max_batch=4)
    out_dir = str(tmp_path / "out")
    peditors.CampNetInfer.example_run(_rows(tmp_path), hp, out_dir=out_dir, device="cpu")
    for i in range(2):
        for suffix in ("", "_ref"):
            wav, sr = load_wav(f"{out_dir}/inplace_{i}{suffix}.wav")
            assert sr == SR and len(wav) > 0 and np.isfinite(wav).all()


def test_csv_command_line_picks_the_family(env, tmp_path, monkeypatch, capsys):
    """``python -m speech_editing_tpu_torch.infer.editors`` picks the driver
    from ``task_cls`` and edits each CSV row from its TextGrid."""
    hp = env("A3TInfer")["port_hp"]
    monkeypatch.chdir(tmp_path)
    shutil.copytree(hp["work_dir"], "checkpoints/tiny")
    os.makedirs("inference/audio/mfa_out")
    rows = _rows(tmp_path)
    lines = ["id,item_name,text,edited_text,wav_fn_orig,edited_region,region"]
    for i, r in enumerate(rows):
        shutil.copyfile(r["mfa_textgrid"], f"inference/audio/mfa_out/{r['item_name']}.TextGrid")
        lines.append(f'{i},{r["item_name"]},"{r["text"]}","{r["edited_text"]}",'
                     f'{r["wav_fn_orig"]},"{r["edited_region"]}","{r["region"]}"')
    (tmp_path / "edits.csv").write_text("\n".join(lines) + "\n")
    cfg = {k: v for k, v in hp.items() if k not in ("work_dir", "infer")}
    (tmp_path / "tiny.yaml").write_text(dump_yaml(dict(cfg, infer_csv="edits.csv",
                                                       mfa_align=False)))
    peditors.main(["--config", "tiny.yaml", "--exp_name", "tiny", "--device", "cpu"])
    assert "| loaded checkpoints/tiny/model_ckpt_steps_1.ckpt (step 1)" in capsys.readouterr().out
    for r in rows:
        wav, sr = load_wav(f"inference/out/{r['item_name']}.wav")
        assert sr == SR and len(wav) > 0 and np.isfinite(wav).all()


def test_serve_cli_routes_the_family(env, tmp_path, capsys):
    """The serve CLI on a CampNet experiment: a 16-bit wav per request with
    the batch server's samples, and no program shape after warmup."""
    e = env("CampNetInfer")
    hp = e["port_hp"]
    cfg = {k: v for k, v in hp.items() if k not in ("work_dir", "infer")}
    cfg["work_dir_root"] = os.path.dirname(hp["work_dir"])
    (tmp_path / "cfg.yaml").write_text(dump_yaml(cfg))
    rows = _rows(tmp_path, names=("srv_0", "srv_1"))
    with open(tmp_path / "reqs.jsonl", "w") as f:
        f.writelines(json.dumps({k: v for k, v in r.items() if k != "mfa_textgrid"}) + "\n"
                     for r in rows)
    out_dir = tmp_path / "out"
    serve_main(["--config", str(tmp_path / "cfg.yaml"), "--exp_name",
                os.path.basename(hp["work_dir"]), "--jsonl", str(tmp_path / "reqs.jsonl"),
                "--out-dir", str(out_dir), "--device", "cpu", "--max-batch", "2", "--warmup",
                "-hp", "serve_wav_int16=True"])
    err = capsys.readouterr().err
    assert "| served 2 requests" in err
    res = e["port"].make_server(e["port"], max_batch=2).edit_many(
        [_load_request({k: v for k, v in r.items() if k != "mfa_textgrid"}, hp) for r in rows])
    for r, got in zip(rows, res):
        sr, data = wavfile.read(out_dir / f"{r['item_name']}.wav")
        assert sr == SR and data.dtype == np.int16 and len(data) == len(got["wav_out"])


def test_online_equals_edit_many_and_warmup_covers_traffic(env):
    port = env("CampNetInfer")["port"]
    reqs = [_make_request(**REQ_A), _make_request(**REQ_B), _make_request(**REQ_C)]
    kw = dict(max_batch=2, frame_buckets=(64, 128), token_buckets=(32, 64))
    batch = BatchedInPlaceEditServer(port, **kw).edit_many(reqs)
    server = BatchedInPlaceEditServer(port, **kw)
    srv = OnlineEditServer(server, max_wait_ms=20, workers=1)
    srv.warmup()
    warmed = set(server.program_shapes)
    futures = [srv.submit(r) for r in reqs]
    results = [f.result(timeout=120) for f in futures]
    srv.close()
    assert server.program_shapes == warmed
    for got, ref in zip(results, batch):
        np.testing.assert_array_equal(got["mel_out"], ref["mel_out"])
