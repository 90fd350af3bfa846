# Copied from kaldi_tpu/pipelines/datadir.py; imports rewritten to kaldi_tpu_torch.
"""On-disk Kaldi data directories: read/write/validate/fix/subset/split.

Parity targets (SURVEY.md §2.2 shared utils): the reference's data
contract is a directory of sorted whitespace tables —
  wav.scp    reco-id → rxfilename (possibly a pipe)
  text       utt-id  → transcript words
  utt2spk    utt-id  → speaker
  spk2utt    speaker → utt-ids (derived)
  segments   utt-id  → reco-id t-begin t-end   (optional)
  feats.scp / cmvn.scp                          (optional)
maintained by utils/validate_data_dir.sh, utils/fix_data_dir.sh,
utils/subset_data_dir.sh, utils/split_data.sh and the
utt2spk_to_spk2utt.pl / spk2utt_to_utt2spk.pl converters.  This module
is those scripts as library functions over the same file formats, so
artifacts round-trip with the in-memory DataSet used by the pipelines.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

from kaldi_tpu_torch.core.logging import KaldiError, get_logger

log = get_logger(__name__)


def utt2spk_to_spk2utt(utt2spk: Dict[str, str]) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for u in sorted(utt2spk):
        out.setdefault(utt2spk[u], []).append(u)
    return out


def spk2utt_to_utt2spk(spk2utt: Dict[str, List[str]]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for s, utts in spk2utt.items():
        for u in utts:
            if u in out:
                raise KaldiError(f"utterance {u} listed under two speakers")
            out[u] = s
    return out


def _read_table(path: str) -> Dict[str, str]:
    """key → rest-of-line (stripped).  Duplicate keys are an error, as
    in the reference's validate_data_dir.sh."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            parts = line.strip().split(None, 1)
            if not parts:
                continue
            key = parts[0]
            if key in out:
                raise KaldiError(f"{path}:{ln}: duplicate key {key}")
            out[key] = parts[1] if len(parts) > 1 else ""
    return out


def _write_table(path: str, table: Dict[str, str]) -> None:
    with open(path, "w") as f:
        for k in sorted(table):
            f.write(f"{k} {table[k]}\n" if table[k] else f"{k}\n")


@dataclasses.dataclass
class DataDir:
    """Parsed data directory.  `segments` maps utt → (reco, tb, te);
    when absent, utt-ids ARE reco-ids (whole-recording utterances)."""
    wav_scp: Dict[str, str]
    text: Dict[str, List[str]]
    utt2spk: Dict[str, str]
    segments: Optional[Dict[str, Tuple[str, float, float]]] = None
    feats_scp: Optional[Dict[str, str]] = None
    cmvn_scp: Optional[Dict[str, str]] = None

    @property
    def utts(self) -> List[str]:
        return sorted(self.utt2spk)

    def spk2utt(self) -> Dict[str, List[str]]:
        return utt2spk_to_spk2utt(self.utt2spk)

    def utt2reco(self, utt: str) -> str:
        return self.segments[utt][0] if self.segments else utt


def read_data_dir(path: str) -> DataDir:
    def table(name: str) -> Optional[Dict[str, str]]:
        p = os.path.join(path, name)
        return _read_table(p) if os.path.exists(p) else None

    utt2spk = table("utt2spk")
    if utt2spk is None:
        spk2utt = table("spk2utt")
        if spk2utt is None:
            raise KaldiError(f"{path}: no utt2spk or spk2utt")
        utt2spk = spk2utt_to_utt2spk(
            {s: v.split() for s, v in spk2utt.items()})
    text = table("text") or {}
    segments_raw = table("segments")
    segments = None
    if segments_raw is not None:
        segments = {}
        for u, rest in segments_raw.items():
            reco, tb, te = rest.split()
            segments[u] = (reco, float(tb), float(te))
    return DataDir(wav_scp=table("wav.scp") or {},
                   text={u: v.split() for u, v in text.items()},
                   utt2spk=utt2spk, segments=segments,
                   feats_scp=table("feats.scp"),
                   cmvn_scp=table("cmvn.scp"))


def write_data_dir(path: str, d: DataDir) -> None:
    os.makedirs(path, exist_ok=True)
    _write_table(os.path.join(path, "wav.scp"), d.wav_scp)
    _write_table(os.path.join(path, "text"),
                 {u: " ".join(w) for u, w in d.text.items()})
    _write_table(os.path.join(path, "utt2spk"), d.utt2spk)
    _write_table(os.path.join(path, "spk2utt"),
                 {s: " ".join(us) for s, us in d.spk2utt().items()})
    if d.segments is not None:
        _write_table(os.path.join(path, "segments"),
                     {u: f"{r} {tb:.3f} {te:.3f}"
                      for u, (r, tb, te) in d.segments.items()})
    if d.feats_scp is not None:
        _write_table(os.path.join(path, "feats.scp"), d.feats_scp)
    if d.cmvn_scp is not None:
        _write_table(os.path.join(path, "cmvn.scp"), d.cmvn_scp)


def validate_data_dir(d: DataDir, require_text: bool = True) -> List[str]:
    """utils/validate_data_dir.sh: returns a list of problems (empty =
    valid).  Checks key-set consistency across tables, segments
    referring to real recordings with sane times, and the reference's
    utt-id-has-speaker-prefix warning is skipped (style-only)."""
    problems: List[str] = []
    utts = set(d.utt2spk)
    if not utts:
        problems.append("empty utt2spk")
    if require_text:
        if set(d.text) != utts:
            problems.append(
                f"text/utt2spk mismatch: {len(d.text)} vs {len(utts)} "
                f"(e.g. {sorted(set(d.text) ^ utts)[:3]})")
    recos = set(d.wav_scp)
    if d.segments is not None:
        if set(d.segments) != utts:
            problems.append("segments/utt2spk key mismatch")
        for u, (reco, tb, te) in d.segments.items():
            if reco not in recos:
                problems.append(f"segments: {u} refers to missing "
                                f"recording {reco}")
            if not (0.0 <= tb < te):
                problems.append(f"segments: {u} has bad times "
                                f"[{tb}, {te})")
    elif recos and utts - recos:
        problems.append(f"utterances missing from wav.scp "
                        f"(e.g. {sorted(utts - recos)[:3]})")
    if d.feats_scp is not None and set(d.feats_scp) != utts:
        problems.append("feats.scp/utt2spk key mismatch")
    if d.cmvn_scp is not None and \
            set(d.cmvn_scp) != set(d.spk2utt()):
        problems.append("cmvn.scp/speaker key mismatch")
    return problems


def fix_data_dir(d: DataDir) -> DataDir:
    """utils/fix_data_dir.sh: keep only utterances present in every
    required table (and whose recording exists), drop the rest."""
    keep = set(d.utt2spk)
    if d.text:
        keep &= set(d.text)
    if d.segments is not None:
        keep &= {u for u in d.segments
                 if not d.wav_scp or d.segments[u][0] in d.wav_scp}
    elif d.wav_scp:
        keep &= set(d.wav_scp)
    if d.feats_scp is not None:
        keep &= set(d.feats_scp)
    dropped = len(d.utt2spk) - len(keep)
    if dropped:
        log.info("fix_data_dir: dropped %d/%d utterances", dropped,
                 len(d.utt2spk))
    segs = ({u: d.segments[u] for u in keep}
            if d.segments is not None else None)
    used_recos = ({r for r, _, _ in segs.values()} if segs is not None
                  else keep)
    return DataDir(
        wav_scp={r: v for r, v in d.wav_scp.items() if r in used_recos},
        text={u: d.text[u] for u in keep if u in d.text},
        utt2spk={u: d.utt2spk[u] for u in keep},
        segments=segs,
        feats_scp=({u: d.feats_scp[u] for u in keep}
                   if d.feats_scp is not None else None),
        cmvn_scp=d.cmvn_scp)


def subset_data_dir(d: DataDir, n: Optional[int] = None,
                    utt_list: Optional[List[str]] = None,
                    speakers: Optional[List[str]] = None,
                    per_spk: Optional[int] = None) -> DataDir:
    """utils/subset_data_dir.sh: --first-n / --utt-list / --spk-list /
    --per-spk selection, then fix."""
    if utt_list is not None:
        keep = set(utt_list)
    elif speakers is not None:
        spks = set(speakers)
        keep = {u for u, s in d.utt2spk.items() if s in spks}
    elif per_spk is not None:
        keep = set()
        for s, us in d.spk2utt().items():
            keep.update(us[:per_spk])
    elif n is not None:
        keep = set(d.utts[:n])
    else:
        raise KaldiError("subset_data_dir: no selection given")
    sub = DataDir(wav_scp=d.wav_scp,
                  text={u: w for u, w in d.text.items() if u in keep},
                  utt2spk={u: s for u, s in d.utt2spk.items()
                           if u in keep},
                  segments=({u: v for u, v in d.segments.items()
                             if u in keep}
                            if d.segments is not None else None),
                  feats_scp=({u: v for u, v in d.feats_scp.items()
                              if u in keep}
                             if d.feats_scp is not None else None),
                  cmvn_scp=d.cmvn_scp)
    return fix_data_dir(sub)


def split_data_dir(d: DataDir, nj: int) -> List[DataDir]:
    """utils/split_data.sh: speaker-contiguous shards (speakers are
    never split across jobs, preserving per-speaker CMVN semantics)."""
    spk2utt = d.spk2utt()
    spks = sorted(spk2utt)
    shards: List[List[str]] = [[] for _ in range(nj)]
    # contiguous speaker blocks balanced by utterance count, like the
    # reference's split_scp.pl --utt2spk mode
    total = sum(len(us) for us in spk2utt.values())
    tgt = total / nj
    j, acc = 0, 0
    for s in spks:
        if j < nj - 1 and acc >= tgt * (j + 1):
            j += 1
        shards[j].extend(spk2utt[s])
        acc += len(spk2utt[s])
    return [subset_data_dir(d, utt_list=sh) for sh in shards if sh]
