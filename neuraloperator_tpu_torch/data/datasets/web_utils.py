"""Dataset downloads (port of ``neuraloperator_tpu/data/datasets/web_utils.py``):
md5-checked URL downloads and Zenodo records, with the standard library.

Where the network cannot be reached the functions raise a
``ConnectionError`` that points at the port's own synthetic generators
(``data.datasets.synthetic``, ``generate_ns_data``), which make every data
set the port's scripts train on.
"""

import hashlib
import json
import os
import shutil
import urllib.request
from pathlib import Path
from typing import List, Optional

_OFFLINE = ("Use the port's synthetic data generators instead "
            "(neuraloperator_tpu_torch.data.datasets.synthetic, "
            "python -m neuraloperator_tpu_torch.scripts.generate_ns_data).")


def download_from_url(url: str, dest: Path, md5: Optional[str] = None,
                      timeout: int = 60) -> Path:
    """Download ``url`` to ``dest``; with ``md5``, a file whose checksum
    differs is deleted and ``ValueError`` raised."""
    dest = Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp, open(dest, "wb") as f:
            shutil.copyfileobj(resp, f)
    except Exception as e:
        raise ConnectionError(f"Could not download {url} (offline environment?). "
                              f"{_OFFLINE}") from e
    if md5 is not None:
        digest = hashlib.md5(dest.read_bytes()).hexdigest()
        if digest != md5:
            dest.unlink()
            raise ValueError(f"md5 mismatch for {url}: expected {md5}, got {digest}")
    return dest


def download_from_zenodo_record(record_id: str, root: Path,
                                files_to_download: Optional[List[str]] = None) -> List[Path]:
    """Download the files of a Zenodo record (those named in
    ``files_to_download``, or all) into ``root``, each md5-checked."""
    api = f"https://zenodo.org/api/records/{record_id}"
    try:
        with urllib.request.urlopen(api, timeout=60) as resp:
            record = json.load(resp)
    except Exception as e:
        raise ConnectionError(f"Could not reach Zenodo record {record_id} (offline "
                              f"environment?). {_OFFLINE}") from e
    out = []
    for f in record.get("files", []):
        name = f.get("key")
        if files_to_download is not None and name not in files_to_download:
            continue
        md5 = f.get("checksum", "").replace("md5:", "") or None
        out.append(download_from_url(f["links"]["self"], Path(root) / name, md5=md5))
    return out


def calculate_md5(fpath, chunk_size: int = 1024 * 1024) -> str:
    """The md5 of a file, read in chunks."""
    md5 = hashlib.md5()
    with open(fpath, "rb") as f:
        for chunk in iter(lambda: f.read(chunk_size), b""):
            md5.update(chunk)
    return md5.hexdigest()


def check_md5(fpath, md5: str) -> bool:
    return md5 == calculate_md5(fpath)


def check_integrity(fpath, md5=None) -> bool:
    if not os.path.isfile(fpath):
        return False
    return True if md5 is None else check_md5(fpath, md5)


__all__ = ["calculate_md5", "check_integrity", "check_md5", "download_from_url",
           "download_from_zenodo_record"]
