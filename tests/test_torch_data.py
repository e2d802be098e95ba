"""PyTorch port, the corpus reader against the JAX package: record files
read both ways, collation, token-budgeted batching, the time masks, f0
normalisation, the phone vocabulary, every item of ``EditingDataset`` and
every batch of the loader, in order, over two shuffled epochs (with the
loader's worker processes and without)."""

import itertools
import json

import numpy as np
import pytest
import torch

from speech_editing_tpu.data import collate as jc
from speech_editing_tpu.data import masks as jm
from speech_editing_tpu.data.datasets import DataLoader as JDataLoader
from speech_editing_tpu.data.datasets import EditingDataset as JEditingDataset
from speech_editing_tpu.data.indexed_dataset import IndexedDataset as JIndexedDataset
from speech_editing_tpu.data.indexed_dataset import \
    IndexedDatasetBuilder as JIndexedDatasetBuilder
from speech_editing_tpu.utils.audio.pitch import norm_interp_f0 as j_norm_interp_f0
from speech_editing_tpu.utils.text import text_encoder as jt
from speech_editing_tpu_torch.data import collate as tc
from speech_editing_tpu_torch.data import masks as tm
from speech_editing_tpu_torch.data.datasets import DataLoader, EditingDataset, EpochBatchSampler
from speech_editing_tpu_torch.data.indexed_dataset import (IndexedDataset,
                                                           IndexedDatasetBuilder)
from speech_editing_tpu_torch.utils.audio.pitch import norm_interp_f0
from speech_editing_tpu_torch.utils.text import text_encoder as tt
from tests.helpers import TINY_HP, synth_corpus_items, write_synth_corpus
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)


def assert_same(got, ref, where=""):
    """Equal structure and values, arrays with equal dtype."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), where
        for k in ref:
            assert_same(got[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype, where
        np.testing.assert_array_equal(got, ref, err_msg=where)
    else:
        assert got == ref and type(got) is type(ref), where


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    write_synth_corpus(str(d), np.random.RandomState(3), n_items=20)
    return str(d)


def _hp(corpus, **kw):
    return dict(TINY_HP, binary_data_dir=corpus, seed=11, max_sentences=3,
                max_tokens=200, sort_by_len=True, training_mask_ratio=0.8, **kw)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_record_files_read_both_ways(tmp_path, writer):
    items = synth_corpus_items(np.random.RandomState(0), 5)
    builder_cls, reader_cls = ((JIndexedDatasetBuilder, IndexedDataset) if writer == "jax"
                               else (IndexedDatasetBuilder, JIndexedDataset))
    builder = builder_cls(str(tmp_path / "split"))
    for it in items:
        builder.add_item(it)
    builder.finalize()
    assert (tmp_path / "split.idx").read_bytes() == _idx_bytes(tmp_path, items)
    reader = reader_cls(str(tmp_path / "split"))
    assert len(reader) == len(items)
    for i in (3, 0, 4, 4):
        assert_same(reader[i], items[i], f"item {i}")
    with pytest.raises(IndexError):
        reader[len(items)]


def _idx_bytes(tmp_path, items):
    """The index file the JAX builder writes for ``items``."""
    b = JIndexedDatasetBuilder(str(tmp_path / "ref"))
    for it in items:
        b.add_item(it)
    b.finalize()
    return (tmp_path / "ref.idx").read_bytes()


def test_collate_and_batching_match_jax(rng):
    seqs = [rng.randn(int(n), 3).astype(np.float32) for n in rng.randint(1, 30, 9)]
    ids = [rng.randint(0, 9, int(n)) for n in rng.randint(1, 30, 9)]
    for kw in ({}, {"left_pad": True}, {"size_multiple": 8}, {"max_len": 40}):
        assert_same(tc.collate_1d_or_2d(seqs, 0.5, **kw), jc.collate_1d_or_2d(seqs, 0.5, **kw))
        assert_same(tc.collate_1d_or_2d(ids, 0, **kw), jc.collate_1d_or_2d(ids, 0, **kw))
    sizes = rng.randint(5, 100, 60)
    order = rng.permutation(60)
    for max_tokens, max_sentences, mult in itertools.product((None, 300), (None, 4), (1, 2)):
        assert tc.batch_by_size(order, lambda i: int(sizes[i]), max_tokens, max_sentences,
                                mult) == jc.batch_by_size(order, lambda i: int(sizes[i]),
                                                          max_tokens, max_sentences, mult)
    with pytest.raises(ValueError):
        tc.batch_by_size(order, lambda i: 500, max_tokens=300)


def test_masks_f0_and_vocabulary_match_jax(rng):
    mel2ph = np.repeat(np.arange(1, 13), rng.randint(1, 9, 12))
    for ratio, seed in itertools.product((0.0, 0.3, 0.8, 1.0), (0, 1, 2)):
        rs = lambda: np.random.RandomState(seed)
        assert_same(tm.generate_time_mask(len(mel2ph), ratio, rs()),
                    jm.generate_time_mask(len(mel2ph), ratio, rs()))
        assert_same(tm.generate_alignment_aware_time_mask(mel2ph, ratio, rs()),
                    jm.generate_alignment_aware_time_mask(mel2ph, ratio, rs()))
        assert_same(tm.generate_inference_mask(mel2ph, ratio, rs()),
                    jm.generate_inference_mask(mel2ph, ratio, rs()))
    empty = np.zeros(5, np.int64)
    assert_same(tm.generate_alignment_aware_time_mask(empty, 0.8, rng),
                jm.generate_alignment_aware_time_mask(empty, 0.8, rng))
    for f0 in (rng.uniform(80, 300, 50) * (rng.rand(50) > 0.3), np.zeros(7),
               rng.uniform(80, 300, 9)):
        f0 = f0.astype(np.float32)
        for got, ref in zip(norm_interp_f0(f0), j_norm_interp_f0(f0)):
            assert_same(got, ref)
    phones = ["AA1", "|", "sil", ",", "B", "<UNK>"]
    port, ref = tt.TokenTextEncoder(phones), jt.TokenTextEncoder(phones)
    assert port.vocab == ref.vocab and port.sil_phonemes() == ref.sil_phonemes()
    assert port.encode("AA1 | XX B") == ref.encode("AA1 | XX B")
    assert port.decode([3, 4, 0, 1, 99]) == ref.decode([3, 4, 0, 1, 99])
    with pytest.raises(KeyError):
        tt.TokenTextEncoder(phones, replace_oov=None).encode("XX")


def test_phone_set_file_round_trip(tmp_path):
    fn = str(tmp_path / "phone_set.json")
    tt.TokenTextEncoder(["A", "|", "B"]).store_to_file(fn)
    assert json.load(open(fn)) == ["A", "|", "B"]
    assert tt.build_token_encoder(fn).vocab == jt.build_token_encoder(fn).vocab


@pytest.mark.parametrize("mask_type", ["alignment_aware", "random"])
def test_items_match_jax_over_two_epochs(corpus, mask_type):
    hp = _hp(corpus, mask_type=mask_type)
    port, ref = EditingDataset("train", hp, shuffle=True), JEditingDataset("train", hp,
                                                                          shuffle=True)
    assert port.sizes == ref.sizes
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert_same(port.ordered_indices(), ref.ordered_indices())
        for i in range(len(ref)):
            item = port[i]
            assert_same(item, ref[i], f"epoch {epoch} item {i}")
            assert item["spk_embed"].shape == (256,)
    infer = dict(hp, infer=True)
    assert_same(EditingDataset("test", infer)[2], JEditingDataset("test", infer)[2])


@pytest.mark.parametrize("ds_workers", [0, 2])
def test_loader_batches_match_jax_over_two_epochs(corpus, ds_workers):
    hp = _hp(corpus, mask_type="alignment_aware")
    port = DataLoader(EditingDataset("train", hp, shuffle=True), max_tokens=200,
                      max_sentences=3, endless=True, num_workers=ds_workers)
    ref = JDataLoader(JEditingDataset("train", hp, shuffle=True), max_tokens=200,
                      max_sentences=3, endless=True)
    n = len(port.sampler.batches(0)) + len(port.sampler.batches(1))
    with port:
        got = list(itertools.islice(port, n))
    want = list(itertools.islice(ref, n))
    assert n > 10 and [len(b["id"]) for b in got] == [len(b["id"]) for b in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, f"batch {i}")
        assert g["spk_embed"].shape == (len(g["id"]), 256)
    valid = DataLoader(EditingDataset("valid", hp), max_sentences=1)
    ref_valid = JDataLoader(JEditingDataset("valid", hp), max_sentences=1)
    for g, w in itertools.zip_longest(valid, ref_valid):
        assert_same(g, w, "valid")


@pytest.mark.parametrize("ds_workers", [0, 2])
def test_pin_memory_loader_yields_the_same_batches_as_tensors(corpus, ds_workers):
    """With ``pin_memory`` (the trainer's on a GPU) every array comes as a
    tensor of the same dtype and values; the pinning itself needs a GPU."""
    hp = _hp(corpus, mask_type="alignment_aware")
    make = lambda pin: DataLoader(EditingDataset("train", hp, shuffle=True), max_tokens=200,
                                  max_sentences=3, num_workers=ds_workers, pin_memory=pin)
    with make(True) as pinned, make(False) as plain:
        pairs = list(itertools.zip_longest(pinned, plain))
    assert len(pairs) > 5
    for i, (g, w) in enumerate(pairs):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert isinstance(g[k], torch.Tensor), f"batch {i}.{k}"
                assert_same(g[k].numpy(), v, f"batch {i}.{k}")
            else:
                assert_same(g[k], v, f"batch {i}.{k}")


def test_unported_dataset_options_raise(corpus):
    """``train_sets``, which the JAX package reads nowhere, raises.
    ``pitch_type: cwt`` is ported (FastSpeech2-orig): its items, and the
    batches of its loader, carry the CWT targets as JAX's do (decomposed
    from the raw f0 here: this corpus has no binarized ones);
    ``use_weighted_sampler`` is ported (the tests below)."""
    with pytest.raises(NotImplementedError) as err:
        EditingDataset("train", _hp(corpus, train_sets="a|b"))
    assert "reads this key nowhere" in str(err.value)
    hp = _hp(corpus, pitch_type="cwt")
    port, ref = EditingDataset("valid", hp), JEditingDataset("valid", hp)
    assert len(ref) > 1
    for i in range(len(ref)):
        assert_same(port[i], ref[i], f"item {i}")
        assert port[i]["cwt_spec"].shape == (port[i]["mel"].shape[0], 10)
    got = list(DataLoader(EditingDataset("valid", hp), max_sentences=3))
    want = list(JDataLoader(JEditingDataset("valid", hp), max_sentences=3))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert {"cwt_spec", "f0_mean", "f0_std"} <= set(w)
        assert_same({k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in g.items()},
                    w, f"batch {i}")


@pytest.fixture(scope="module")
def stutter_corpus(tmp_path_factory):
    """A corpus whose items carry per-frame stutter labels (spans on about
    a fifth of each item's frames, none on every third item), so the
    weights of the weighted sampler differ from item to item."""
    from speech_editing_tpu.data.indexed_dataset import IndexedDatasetBuilder as JBuilder

    d = str(tmp_path_factory.mktemp("stutter_corpus"))
    rs = np.random.RandomState(5)
    for prefix in ("train", "valid", "test"):
        items = synth_corpus_items(rs, 16)
        builder = JBuilder(f"{d}/{prefix}")
        for i, it in enumerate(items):
            lab = np.zeros(len(it["mel"]), np.int64)
            if i % 3:
                start = rs.randint(0, len(lab) // 2)
                lab[start:start + len(lab) // 5] = 1
            builder.add_item(dict(it, stutter_mel_mask=lab))
        builder.finalize()
        np.save(f"{d}/{prefix}_lengths.npy", np.asarray([len(it["mel"]) for it in items]))
    return d


@pytest.mark.parametrize("ds_workers", [0, 2])
def test_weighted_sampler_batches_match_jax_over_two_epochs(stutter_corpus, ds_workers):
    """``use_weighted_sampler``: each epoch's draw of (10 + stutter frames)
    / frames weighted items with replacement, the items' masks keyed on
    the virtual index, the loader's batches over two epochs, in this
    process and in worker processes: all equal to JAX's. The loader's
    dataset is fresh (no epoch drawn yet) when its workers take their
    copies of it, as the trainer's is."""
    hp = _hp(stutter_corpus, mask_type="random", use_weighted_sampler=True)
    port, ref = EditingDataset("train", hp, shuffle=True), JEditingDataset("train", hp,
                                                                          shuffle=True)
    np.testing.assert_array_equal(port.sample_weights(), ref.sample_weights())
    assert len(set(port.sample_weights())) > 3
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        np.testing.assert_array_equal(port._index_map, ref._index_map)
        assert len(set(port._index_map)) < len(port)          # drawn with replacement
        assert_same(port.ordered_indices(), ref.ordered_indices())
        for i in range(len(ref)):
            assert_same(port[i], ref[i], f"epoch {epoch} item {i}")
    count = EpochBatchSampler(EditingDataset("train", hp, shuffle=True), max_tokens=200,
                              max_sentences=3)
    n = len(count.batches(0)) + len(count.batches(1))
    loader = DataLoader(EditingDataset("train", hp, shuffle=True), max_tokens=200,
                        max_sentences=3, endless=True, num_workers=ds_workers)
    assert loader.dataset._index_map is None
    with loader:
        got = list(itertools.islice(loader, n))
    want = list(itertools.islice(JDataLoader(JEditingDataset("train", hp, shuffle=True),
                                             max_tokens=200, max_sentences=3,
                                             endless=True), n))
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, f"batch {i}")
    unweighted = EditingDataset("train", dict(hp, use_weighted_sampler=False), shuffle=True)
    unweighted.set_epoch(0)
    assert unweighted._index_map is None


def test_weighted_concat_dataset_matches_jax(stutter_corpus, corpus):
    """Two children, one with stutter labels and one without (weights 1):
    the draw at the concat level, no child map, each child's masks salted
    with the virtual index; sizes, order and items equal JAX's."""
    from speech_editing_tpu.data.datasets import ConcatDataset as JConcat

    from speech_editing_tpu_torch.data.datasets import ConcatDataset

    hp = _hp(stutter_corpus, mask_type="random", use_weighted_sampler=True)
    plain_hp = dict(hp, binary_data_dir=corpus)
    port = ConcatDataset([EditingDataset("train", hp, shuffle=True),
                          EditingDataset("train", plain_hp, shuffle=True)])
    ref = JConcat([JEditingDataset("train", hp, shuffle=True),
                   JEditingDataset("train", plain_hp, shuffle=True)])
    assert port.sizes == ref.sizes
    np.testing.assert_array_equal(port.sample_weights(), ref.sample_weights())
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        np.testing.assert_array_equal(port._index_map, ref._index_map)
        assert all(d._index_map is None for d in port.datasets)
        assert_same(port.ordered_indices(), ref.ordered_indices())
        for i in range(len(ref)):
            assert_same(port[i], ref[i], f"epoch {epoch} item {i}")
        first = [i for i in range(len(ref)) if ref._index_map[i] < len(ref.datasets[0])][:3]
        assert_same(port.collater([port[i] for i in first]),
                    ref.collater([ref[i] for i in first]))
