"""Benchmark dataset / prior-weights fetcher: the logic, kept as the port's
own copy of fusionsense_tpu/data/download.py.

One registry-driven fetcher: stdlib urllib streaming download +
tarfile/zipfile extraction, no external wget/tar/unzip processes, resumable
re-runs (existing archives are kept, extraction is idempotent). Where the
first artifact cannot be reached (no egress), the error lists the URLs to
mirror instead of a stack trace; the registry doubles as the documentation
of exactly which artifacts each benchmark needs.
"""
from __future__ import annotations

import dataclasses
import sys
import tarfile
import urllib.error
import urllib.request
import zipfile
from pathlib import Path
from typing import Callable, Optional

MUSHROOM_ROOMS = (
    "coffee_room", "computer", "classroom", "honka", "koivu",
    "vr_room", "kokko", "sauna", "activity", "olohuone",
)

# per-room zenodo records (reference mushroom_download.py:31-39)
_MUSHROOM_RECORDS = {
    "iphone": "10230733",
    "kinect": "10209072",
    "mesh_pd": "10222321",
}


@dataclasses.dataclass(frozen=True)
class Artifact:
    url: str
    # archive member extraction root, relative to save_dir; None = no
    # extraction (single-file artifact, e.g. checkpoint weights)
    extract_to: Optional[str] = ""
    approx_size: str = ""


def _mushroom_artifacts(room: str, sequence: str) -> list[Artifact]:
    if room not in MUSHROOM_ROOMS:
        raise ValueError(f"unknown MuSHRoom room {room!r}; "
                         f"one of {MUSHROOM_ROOMS}")
    seqs = ("iphone", "kinect", "mesh_pd") if sequence == "all" \
        else (("mesh_pd",) if sequence == "faro" else (sequence,))
    return [
        Artifact(
            url=(f"https://zenodo.org/records/{_MUSHROOM_RECORDS[s]}"
                 f"/files/{room}_{s}.tar.gz"),
            extract_to="",
        )
        for s in seqs
    ]


# name -> (artifact list | factory taking CLI options)
REGISTRY: dict[str, Callable[..., list[Artifact]]] = {
    # reference mushroom_download.py
    "mushroom": _mushroom_artifacts,
    # reference replica_download.py (12.4 GB pre-processed, nice-slam)
    "replica": lambda: [Artifact(
        "https://cvg-data.inf.ethz.ch/nice-slam/data/Replica.zip",
        extract_to="", approx_size="12.4G")],
    # reference dtu_download.py (monosdf preprocessing)
    "dtu": lambda: [Artifact(
        "https://s3.eu-central-1.amazonaws.com/avg-projects/monosdf/data/DTU.tar",
        extract_to="")],
    # reference nrgbd_download.py (sequences + GT meshes)
    "nrgbd": lambda: [
        Artifact("http://kaldir.vc.in.tum.de/neural_rgbd/neural_rgbd_data.zip",
                 extract_to="NRGBD"),
        Artifact("http://kaldir.vc.in.tum.de/neural_rgbd/meshes.zip",
                 extract_to="NRGBD"),
    ],
    # reference download_omnidata.py (DPT-hybrid normal weights; convert
    # with tools/convert_omnidata.py after download)
    "omnidata": lambda: [Artifact(
        "https://zenodo.org/records/10447888/files/omnidata_dpt_normal_v2.ckpt",
        extract_to=None)],
}


def _stream_download(url: str, dest: Path, log=print) -> None:
    tmp = dest.with_suffix(dest.suffix + ".part")
    req = urllib.request.Request(url, headers={"User-Agent": "fusionsense-tpu-torch"})
    with urllib.request.urlopen(req, timeout=60) as r, open(tmp, "wb") as f:
        total = int(r.headers.get("Content-Length") or 0)
        done = 0
        while True:
            chunk = r.read(1 << 22)
            if not chunk:
                break
            f.write(chunk)
            done += len(chunk)
            if total:
                log(f"\r  {dest.name}: {done / 1e6:.0f}/{total / 1e6:.0f} MB",
                    end="")
        log("")
    tmp.replace(dest)


def _safe_tar_extract(tf: "tarfile.TarFile", out_dir: Path) -> None:
    """extractall with path-traversal protection on every interpreter we
    declare support for: the `filter="data"` kwarg only exists from
    3.10.12/3.11.4 (pyproject requires >=3.10), so older patch releases
    fall back to a manual member-path check."""
    try:
        tf.extractall(out_dir, filter="data")
    except TypeError:  # filter kwarg not available on this interpreter
        base = out_dir.resolve()
        for m in tf.getmembers():
            target = (out_dir / m.name).resolve()
            if base != target and base not in target.parents:
                raise RuntimeError(
                    f"archive member escapes extraction dir: {m.name!r}")
            if m.issym() or m.islnk():
                raise RuntimeError(
                    f"refusing link member without filter support: {m.name!r}")
        tf.extractall(out_dir)


def _extract(archive: Path, out_dir: Path, log=print) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    log(f"  extracting {archive.name} -> {out_dir}")
    if archive.name.endswith((".tar.gz", ".tgz", ".tar")):
        with tarfile.open(archive) as tf:
            _safe_tar_extract(tf, out_dir)
    elif archive.suffix == ".zip":
        with zipfile.ZipFile(archive) as zf:
            zf.extractall(out_dir)
    else:
        raise ValueError(f"unknown archive format: {archive.name}")


def fetch(dataset: str, save_dir: Path, *, keep_archives: bool = False,
          log=print, **options) -> list[Path]:
    """Download + extract one registry entry. Returns produced paths.

    Air-gap behavior: if the very first byte of the first artifact cannot
    be fetched, raises RuntimeError listing every URL the caller needs to
    mirror manually (so the registry is useful even with zero egress).
    """
    if dataset not in REGISTRY:
        raise ValueError(f"unknown dataset {dataset!r}; "
                         f"one of {sorted(REGISTRY)}")
    artifacts = REGISTRY[dataset](**options)
    save_dir.mkdir(parents=True, exist_ok=True)
    produced: list[Path] = []
    for art in artifacts:
        name = art.url.rsplit("/", 1)[-1]
        dest = save_dir / name
        # idempotent re-runs: a per-ARTIFACT sentinel written after a
        # successful extraction means the archive was fetched and (by
        # default) deleted — don't re-download multi-GB artifacts just
        # because keep_archives=False removed them. The sentinel is
        # per-archive (not per-directory): several artifacts may share an
        # extract_to, and extract_to="" is save_dir itself, so directory
        # non-emptiness would wrongly skip sibling artifacts.
        marker = save_dir / f".{name}.extracted"
        if art.extract_to is not None:
            out = save_dir / art.extract_to
            if not dest.exists() and marker.exists():
                log(f"skipping {name}: already extracted ({marker.name})")
                produced.append(out)
                continue
        if not dest.exists():
            log(f"fetching {art.url}"
                + (f" (~{art.approx_size})" if art.approx_size else ""))
            try:
                _stream_download(art.url, dest, log=log)
            except (urllib.error.URLError, OSError, TimeoutError) as e:
                urls = "\n  ".join(a.url for a in artifacts)
                raise RuntimeError(
                    f"cannot reach {art.url!r} ({e}). If this environment "
                    f"has no egress, mirror these into {save_dir}:\n  {urls}"
                ) from e
        if art.extract_to is None:
            produced.append(dest)
            continue
        _extract(dest, save_dir / art.extract_to, log=log)
        marker.touch()
        produced.append(save_dir / art.extract_to)
        if not keep_archives:
            dest.unlink()
    return produced


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m fusionsense_tpu_torch.data.download",
        description="Fetch benchmark datasets / prior weights "
                    "(mushroom, replica, dtu, nrgbd, omnidata).")
    ap.add_argument("dataset", choices=sorted(REGISTRY))
    ap.add_argument("--save-dir", type=Path, default=Path("datasets"))
    ap.add_argument("--room", default="activity",
                    help="mushroom: room name")
    ap.add_argument("--sequence", default="all",
                    choices=["iphone", "kinect", "faro", "all"],
                    help="mushroom: capture sequence")
    ap.add_argument("--keep-archives", action="store_true")
    args = ap.parse_args(argv)
    opts = {}
    if args.dataset == "mushroom":
        opts = {"room": args.room, "sequence": args.sequence}
    try:
        paths = fetch(args.dataset, args.save_dir,
                      keep_archives=args.keep_archives, **opts)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    for p in paths:
        print(p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
