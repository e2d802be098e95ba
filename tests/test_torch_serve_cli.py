"""PyTorch port, the online serve CLI ``python -m
speech_editing_tpu_torch.infer.serve --device cpu`` over a JSONL of two
requests carrying a precomputed ``mel2ph`` on the tiny serving env with a
tiny HiFi-GAN: it writes a 16-bit wav per request, the samples of the
batch server's result for the same request, with and without ``--fast-io``;
a latency line per request and the ``served N requests: latency p50 / p99``
line; and after ``--warmup`` the traffic adds no program shape. Without
``--device cpu`` it needs a GPU."""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from speech_editing_tpu_torch.config.hparams import dump_yaml
from speech_editing_tpu_torch.infer.serve import _load_request
from speech_editing_tpu_torch.infer.serve import main as serve_main
from speech_editing_tpu_torch.infer.serving import BatchedEditServer
from speech_editing_tpu_torch.infer.spec_denoiser import SpecDenoiserInfer
from speech_editing_tpu_torch.utils.audio.io import save_wav
from tests.test_serving import REQ_A, REQ_C, _make_request
from tests.test_torch_serving import serve_env, write_vocoder
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

SR = 22050


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The config, the experiment's name, the JSONL file, its rows and the
    hparams of the tiny env."""
    tmp = tmp_path_factory.mktemp("serve_cli")
    hp = dict(serve_env(tmp), vocoder="HifiGAN", vocoder_ckpt=write_vocoder(tmp / "voc"))
    cfg = {k: v for k, v in hp.items() if k not in ("work_dir", "infer")}
    cfg["work_dir_root"] = os.path.dirname(hp["work_dir"])
    (tmp / "cfg.yaml").write_text(dump_yaml(cfg))
    rows = []
    for i, req in enumerate((REQ_A, REQ_C)):
        inp = _make_request(**dict(req, name=f"srv_{i}"))
        wav_fn = str(tmp / f"src{i}.wav")
        save_wav(inp["wav"], wav_fn, SR)
        rows.append({"item_name": inp["item_name"], "text": inp["text"],
                     "edited_text": inp["edited_text"], "region": inp["region"],
                     "edited_region": inp["edited_region"], "wav_fn_orig": wav_fn,
                     "mel2ph": [int(m) for m in inp["mel2ph"]]})
    with open(tmp / "reqs.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return str(tmp / "cfg.yaml"), os.path.basename(hp["work_dir"]), str(tmp / "reqs.jsonl"), \
        rows, hp


@pytest.mark.parametrize("fast_io", [False, True])
def test_serve_cli_writes_each_request(setup, tmp_path, capsys, fast_io):
    cfg, exp, jsonl, rows, hp = setup
    out_dir = tmp_path / "out"
    serve_main(["--config", cfg, "--exp_name", exp, "--jsonl", jsonl, "--out-dir",
                str(out_dir), "--max-wait-ms", "20", "--max-batch", "2", "--workers", "2",
                "--device", "cpu"] + (["--fast-io"] if fast_io else ["--warmup"]))
    err = capsys.readouterr().err
    assert "| served 2 requests: latency p50" in err
    assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
    if not fast_io:
        warmed = int(err.split("| warmup: ")[-1].split(" program shapes")[0])
        assert f"; {warmed} program shapes run" in err      # none added by the traffic
    server = BatchedEditServer(SpecDenoiserInfer(hp, device="cpu"), max_batch=2)
    for row in rows:
        assert f"| {row['item_name']}: " in err
        res = server.edit_many([_load_request(row, hp)])[0]
        save_wav(res["wav_out"], str(tmp_path / "ref.wav"), SR)
        sr, data = wavfile.read(str(out_dir / f"{row['item_name']}.wav"))
        assert sr == SR and data.dtype == np.int16
        np.testing.assert_array_equal(data, wavfile.read(str(tmp_path / "ref.wav"))[1])


def test_serve_cli_needs_a_gpu_without_device_cpu(setup):
    cfg, exp, jsonl, _, _ = setup
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(["--config", cfg, "--exp_name", exp, "--jsonl", jsonl])
