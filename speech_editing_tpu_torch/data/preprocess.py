"""Offline preprocessing: a raw corpus -> normalised text, phones and the
inputs of the Montreal Forced Aligner (MFA). The port's copy of the JAX
package's ``data/preprocess.py``:

    python -m speech_editing_tpu_torch.data.preprocess --config egs/spec_denoiser.yaml \
        [-hp raw_data_dir=...,processed_data_dir=...]

The meta loaders of ``stutter_set``, ``vctk`` and ``libritts``; two passes
(g2p and wav staging, then token encoding); the phone, word and speaker
maps (``phone_set.json``, ``word_set.json``, ``spk_map.json``); the MFA
corpus, grouped, with a ``.lab`` file per wav and ``mfa_dict.txt``; and
``metadata.json``, the binarizer's input. Host Python throughout: nothing
here runs on a device.
"""

from __future__ import annotations

import json
import os
import random
import re
import shutil
from collections import Counter
from glob import glob
from typing import Iterator, Optional

from speech_editing_tpu_torch.data.wav_processors import run_wav_processors
from speech_editing_tpu_torch.utils.multiprocess import multiprocess_run_tqdm
from speech_editing_tpu_torch.utils.text.processors import get_txt_processor_cls, txt_to_ph
from speech_editing_tpu_torch.utils.text.text_encoder import (TokenTextEncoder,
                                                              build_token_encoder,
                                                              is_sil_phoneme)


class BasePreprocessor:
    def __init__(self, hp: Optional[dict] = None):
        hp = hp or {}
        self.hp = hp
        self.dataset_name = hp.get("ds_name", "vctk")
        self.raw_data_dir = hp.get("raw_data_dir", f"data/raw/{self.dataset_name}")
        self.processed_dir = hp.get("processed_data_dir", f"data/processed/{self.dataset_name}")
        self.txt_processor = get_txt_processor_cls(hp.get("language", "en"))
        self.spk_map_fn = f"{self.processed_dir}/spk_map.json"
        self.reset_phone_dict = True
        self.reset_word_dict = True
        self.word_dict_size = hp.get("word_dict_size", 12500)
        self.num_spk = hp.get("num_spk", 1200)
        self.use_mfa = hp.get("use_mfa", True)
        self.seed = hp.get("seed", 1234)
        self.nsample_per_mfa_group = hp.get("nsample_per_mfa_group", 1000)
        self.mfa_group_shuffle = hp.get("mfa_group_shuffle", False)
        self.wav_processed_dirname = "wav_processed"
        self.meta_csv_filename = "metadata"

    def meta_data(self) -> Iterator[dict]:
        """The raw corpus's items: ``item_name``, ``wav_fn``, ``txt`` and
        ``spk_name``."""
        if self.dataset_name == "stutter_set":
            spk_of_video = {}
            with open(f"{self.raw_data_dir}/video_spk.txt") as f:
                for line in f:
                    parts = line.split(" ")
                    spk_of_video[parts[0]] = parts[1]
            with open(f"{self.raw_data_dir}/metadata.csv") as f:
                for r in f:
                    wav_fn = r.split("|")[0]
                    item_name = os.path.basename(wav_fn)[:-4]
                    yield {"item_name": item_name, "wav_fn": wav_fn,
                           "txt": r.split("|")[1].replace("\n", ""),
                           "spk_name": spk_of_video[item_name[0:13]]}
        elif self.dataset_name == "vctk":
            for wav_fn in sorted(glob(f"{self.raw_data_dir}/wav48/*/*.wav")):
                txt_fn = wav_fn.replace("/wav48/", "/txt/")[:-4] + ".txt"
                if os.path.exists(txt_fn):
                    with open(txt_fn) as f:
                        txt = f.read()
                    yield {"item_name": os.path.basename(wav_fn)[:-4], "wav_fn": wav_fn,
                           "txt": txt, "spk_name": wav_fn.split("/")[-2]}
        elif self.dataset_name == "libritts":
            for wav_fn in sorted(glob(f"{self.raw_data_dir}/*/*/*/*.wav")):
                item_name = os.path.basename(wav_fn)[:-4]
                with open(f"{wav_fn[:-4]}.normalized.txt") as f:
                    txt = f.read()
                yield {"item_name": item_name, "wav_fn": wav_fn, "txt": txt,
                       "spk_name": item_name.split("_")[0]}
        else:
            raise NotImplementedError(f"ds_name={self.dataset_name}; add a meta_data loader")

    @classmethod
    def preprocess_first_pass(cls, item_name, txt_raw, txt_processor, wav_fn,
                              wav_processed_dir, wav_processed_tmp, wav_processors=(), **kw):
        """g2p of ``txt_raw`` and the wav staged (linked, or copied after
        the wav processors) into ``wav_processed_dir``; ``None`` on error."""
        try:
            ph, txt, word, ph2word, ph_gb_word = txt_to_ph(txt_processor, txt_raw)
            ext = os.path.splitext(wav_fn)[1]
            os.makedirs(wav_processed_dir, exist_ok=True)
            new_wav_fn = f"{wav_processed_dir}/{item_name}{ext}"
            processed_fn = run_wav_processors(wav_fn, wav_processed_tmp, wav_processors)
            if processed_fn != wav_fn:
                shutil.copyfile(processed_fn, new_wav_fn)
            else:
                try:
                    if os.path.lexists(new_wav_fn):
                        os.remove(new_wav_fn)
                    os.link(wav_fn, new_wav_fn)
                except OSError:
                    shutil.copyfile(wav_fn, new_wav_fn)
            return {"txt": txt, "txt_raw": txt_raw, "ph": ph, "word": word,
                    "ph2word": ph2word, "ph_gb_word": ph_gb_word,
                    "wav_fn": new_wav_fn, "wav_align_fn": wav_fn}
        except Exception:
            import traceback

            traceback.print_exc()
            print(f"| Error in first pass: {item_name}")
            return None

    @staticmethod
    def preprocess_second_pass(word, ph, spk_name, word_encoder, ph_encoder, spk_map, **kw):
        return {"word_token": word_encoder.encode(word), "ph_token": ph_encoder.encode(ph),
                "spk_id": spk_map[spk_name]}

    def _phone_encoder(self, ph_set) -> TokenTextEncoder:
        fn = f"{self.processed_dir}/phone_set.json"
        if self.reset_phone_dict or not os.path.exists(fn):
            with open(fn, "w") as f:
                json.dump(sorted(set(ph_set)), f, ensure_ascii=False)
        return build_token_encoder(fn)

    def _word_encoder(self, word_set) -> TokenTextEncoder:
        fn = f"{self.processed_dir}/word_set.json"
        if self.reset_word_dict or not os.path.exists(fn):
            counts = Counter(word_set).most_common(self.word_dict_size)
            with open(fn, "w") as f:
                json.dump(sorted([w for w, _ in counts]), f, ensure_ascii=False)
        return build_token_encoder(fn)

    def build_spk_map(self, spk_names) -> dict:
        spk_map = {name: i for i, name in enumerate(sorted(spk_names))}
        with open(self.spk_map_fn, "w") as f:
            json.dump(spk_map, f, ensure_ascii=False)
        return spk_map

    @classmethod
    def build_mfa_inputs(cls, item, mfa_input_dir, mfa_group, wav_processed_tmp, **kw):
        """The item's wav and its ``.lab`` (the words' phones without
        silences) in its MFA group's directory."""
        item_name = item["item_name"]
        wav_align_fn = item["wav_align_fn"]
        group_dir = f"{mfa_input_dir}/{mfa_group}"
        os.makedirs(group_dir, exist_ok=True)
        ph_gb_word_nosil = " ".join(
            ["_".join([p for p in w.split("_") if not is_sil_phoneme(p)])
             for w in item["ph_gb_word"].split(" ") if not is_sil_phoneme(w)])
        ext = os.path.splitext(wav_align_fn)[1]
        new_wav_align_fn = f"{group_dir}/{item_name}{ext}"
        shutil.copyfile(wav_align_fn, new_wav_align_fn)
        with open(f"{group_dir}/{item_name}.lab", "w") as f:
            f.write(ph_gb_word_nosil)
        return ph_gb_word_nosil, new_wav_align_fn

    def process(self) -> list:
        """Both passes, the maps, the MFA inputs and ``metadata.json``;
        returns the items."""
        processed_dir = self.processed_dir
        wav_processed_tmp = f"{processed_dir}/processed_tmp"
        wav_processed_dir = f"{processed_dir}/{self.wav_processed_dirname}"
        for d in (wav_processed_tmp, wav_processed_dir):
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d, exist_ok=True)

        meta = list(self.meta_data())
        names = [d["item_name"] for d in meta]
        if len(names) != len(set(names)):
            raise ValueError("item_name must be unique")

        args = [{"item_name": d["item_name"], "txt_raw": d["txt"], "wav_fn": d["wav_fn"],
                 "txt_processor": self.txt_processor,
                 "wav_processed_dir": wav_processed_dir,
                 "wav_processed_tmp": wav_processed_tmp,
                 "wav_processors": self.hp.get("wav_processors", ())} for d in meta]
        items, phone_list, word_list, spk_names = [], [], [], set()
        for raw, (item_id, out) in zip(meta, multiprocess_run_tqdm(
                self.preprocess_first_pass, args, desc="Preprocess")):
            if out is None:
                continue
            item = dict(raw)
            item.update(out)
            item["id"] = item_id
            item["spk_name"] = item.get("spk_name", "<SINGLE_SPK>")
            phone_list += item["ph"].split(" ")
            word_list += item["word"].split(" ")
            spk_names.add(item["spk_name"])
            items.append(item)

        ph_encoder = self._phone_encoder(phone_list)
        word_encoder = self._word_encoder(word_list)
        spk_map = self.build_spk_map(spk_names)
        args = [{"ph": it["ph"], "word": it["word"], "spk_name": it["spk_name"],
                 "word_encoder": word_encoder, "ph_encoder": ph_encoder, "spk_map": spk_map}
                for it in items]
        for idx, kv in multiprocess_run_tqdm(self.preprocess_second_pass, args,
                                             desc="Encode tokens"):
            items[idx].update(kv)

        if self.use_mfa:
            mfa_dict = set()
            mfa_input_dir = f"{processed_dir}/mfa_inputs"
            shutil.rmtree(mfa_input_dir, ignore_errors=True)
            groups = [i // self.nsample_per_mfa_group for i in range(len(items))]
            if self.mfa_group_shuffle:
                random.seed(self.seed)
                random.shuffle(groups)
            args = [{"item": it, "mfa_input_dir": mfa_input_dir, "mfa_group": g,
                     "wav_processed_tmp": wav_processed_tmp} for it, g in zip(items, groups)]
            for i, out in multiprocess_run_tqdm(self.build_mfa_inputs, args,
                                                desc="Build MFA data"):
                if out is None:
                    continue
                ph_gb_word_nosil, new_fn = out
                items[i]["wav_align_fn"] = new_fn
                for w in ph_gb_word_nosil.split(" "):
                    mfa_dict.add(f"{w} {w.replace('_', ' ')}")
            with open(f"{processed_dir}/mfa_dict.txt", "w") as f:
                f.writelines([f"{line}\n" for line in sorted(mfa_dict)])

        with open(f"{processed_dir}/{self.meta_csv_filename}.json", "w") as f:
            f.write(re.sub(r"\n\s+([\d+\]])", r"\1",
                           json.dumps(items, ensure_ascii=False, sort_keys=False, indent=1)))
        shutil.rmtree(wav_processed_tmp, ignore_errors=True)
        print(f"| preprocessed {len(items)} items -> {processed_dir}")
        return items


def main(argv=None) -> list:
    from speech_editing_tpu_torch.config.hparams import arg_parser, set_hparams

    return BasePreprocessor(set_hparams(arg_parser().parse_args(argv),
                                        print_hparams=False)).process()


if __name__ == "__main__":
    main()
