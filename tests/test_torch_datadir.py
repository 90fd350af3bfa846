"""The port's data-directory utilities (kaldi_tpu_torch/pipelines/datadir.py,
a copy of the JAX package's): the tests of tests/test_datadir.py on the
port's copy (round-trip, validate, fix, subset, split), and a data
directory written by either package read back equal by the other.
"""

import pytest

from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu.pipelines import datadir as jdd
from kaldi_tpu_torch.pipelines.datadir import (DataDir, fix_data_dir,
                                               read_data_dir, split_data_dir,
                                               subset_data_dir,
                                               spk2utt_to_utt2spk,
                                               utt2spk_to_spk2utt,
                                               validate_data_dir,
                                               write_data_dir)


def make_dir(n_spk=3, per_spk=4):
    utt2spk, text, wav = {}, {}, {}
    for s in range(n_spk):
        for i in range(per_spk):
            u = f"spk{s}-utt{i}"
            utt2spk[u] = f"spk{s}"
            text[u] = ["HELLO", "WORLD"]
            wav[u] = f"/data/{u}.wav"
    return DataDir(wav_scp=wav, text=text, utt2spk=utt2spk)


def test_roundtrip(tmp_path):
    d = make_dir()
    write_data_dir(str(tmp_path / "data"), d)
    d2 = read_data_dir(str(tmp_path / "data"))
    assert d2.utt2spk == d.utt2spk
    assert d2.text == d.text
    assert d2.wav_scp == d.wav_scp
    assert validate_data_dir(d2) == []


def test_segments_roundtrip_and_validate(tmp_path):
    d = make_dir(n_spk=1, per_spk=2)
    d.segments = {u: ("reco0", 0.5 * i, 0.5 * i + 0.4)
                  for i, u in enumerate(d.utts)}
    d.wav_scp = {"reco0": "/data/reco0.wav"}
    assert validate_data_dir(d) == []
    write_data_dir(str(tmp_path / "d"), d)
    d2 = read_data_dir(str(tmp_path / "d"))
    assert d2.segments.keys() == d.segments.keys()
    assert d2.segments[d.utts[1]][1] == pytest.approx(0.5)
    assert d2.utt2reco(d.utts[0]) == "reco0"
    # bad: segment points at a missing recording
    d.segments[d.utts[0]] = ("nosuch", 0.0, 0.4)
    assert any("missing recording" in p for p in validate_data_dir(d))


def test_validate_catches_mismatch_and_fix_repairs():
    d = make_dir()
    del d.text[d.utts[0]]
    bad_wav = d.utts[1]
    del d.wav_scp[bad_wav]
    assert validate_data_dir(d) != []
    fixed = fix_data_dir(d)
    assert validate_data_dir(fixed) == []
    assert len(fixed.utt2spk) == len(d.utt2spk) - 2


def test_spk2utt_conversions():
    d = make_dir()
    s2u = utt2spk_to_spk2utt(d.utt2spk)
    assert spk2utt_to_utt2spk(s2u) == d.utt2spk
    with pytest.raises(KaldiError):
        spk2utt_to_utt2spk({"a": ["u1"], "b": ["u1"]})


def test_subset_modes():
    d = make_dir(n_spk=3, per_spk=4)
    assert len(subset_data_dir(d, n=5).utt2spk) == 5
    per = subset_data_dir(d, per_spk=2)
    assert all(len(us) == 2 for us in per.spk2utt().values())
    spk = subset_data_dir(d, speakers=["spk1"])
    assert set(spk.utt2spk.values()) == {"spk1"}
    assert validate_data_dir(spk) == []


def test_split_speaker_contiguous():
    d = make_dir(n_spk=5, per_spk=3)
    shards = split_data_dir(d, 2)
    assert len(shards) == 2
    # speakers never split across shards
    seen = {}
    for i, sh in enumerate(shards):
        for s in set(sh.utt2spk.values()):
            assert seen.setdefault(s, i) == i
    assert sum(len(s.utt2spk) for s in shards) == 15
    # balanced within one speaker's worth
    sizes = sorted(len(s.utt2spk) for s in shards)
    assert sizes[1] - sizes[0] <= 3


def test_duplicate_key_rejected(tmp_path):
    p = tmp_path / "data"
    p.mkdir()
    (p / "utt2spk").write_text("u1 s1\nu1 s2\n")
    with pytest.raises(KaldiError):
        read_data_dir(str(p))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_data_dir_files_cross(tmp_path, writer):
    """Every table, segments and the feats/cmvn scps included, written by
    one package and read by the other, with the same validation."""
    d = make_dir(n_spk=2, per_spk=3)
    d.segments = {u: ("reco0", 0.5 * i, 0.5 * i + 0.4)
                  for i, u in enumerate(d.utts)}
    d.wav_scp = {"reco0": "/data/reco0.wav"}
    d.feats_scp = {u: f"feats.ark:{10 * i}" for i, u in enumerate(d.utts)}
    d.cmvn_scp = {"spk0": "cmvn.ark:5", "spk1": "cmvn.ark:90"}
    path = str(tmp_path / "d")
    if writer == "jax":
        jdd.write_data_dir(path, jdd.DataDir(**vars(d)))
        back = read_data_dir(path)
    else:
        write_data_dir(path, d)
        back = jdd.read_data_dir(path)
    for name in ("wav_scp", "text", "utt2spk", "segments", "feats_scp",
                 "cmvn_scp"):
        assert getattr(back, name) == getattr(d, name), name
    assert validate_data_dir(d) == jdd.validate_data_dir(back) == []
