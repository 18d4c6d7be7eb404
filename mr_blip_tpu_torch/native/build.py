"""Build the native video decoder (``video_decoder.cpp``, FFmpeg) at first use.

``g++`` compiles it into ``mr_blip_tpu_torch/_build/native/<hash>/
libvideodecoder.so``, keyed by a hash of the source and the flags, with
FFmpeg's compile and link flags from ``pkg-config`` (libavformat, libavcodec,
libavutil, libswscale). The library is written under a temporary name and
renamed into place, so two processes building at once never load a partial
file. Nothing is built when this module is imported; where ``pkg-config``
finds no FFmpeg, ``build`` raises ``FFmpegUnavailable``.

    python -m mr_blip_tpu_torch.native.build    # build now, print the path
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "video_decoder.cpp"
BUILD_ROOT = _DIR.parent / "_build" / "native"
PACKAGES = ("libavformat", "libavcodec", "libavutil", "libswscale")
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]


class FFmpegUnavailable(RuntimeError):
    """pkg-config found no FFmpeg development files (or no pkg-config)."""


def ffmpeg_flags() -> tuple[list[str], list[str]]:
    """FFmpeg's (cflags, libs) from ``pkg-config``."""
    try:
        return tuple(
            subprocess.run(["pkg-config", flag, *PACKAGES], capture_output=True,
                           text=True, check=True).stdout.split()
            for flag in ("--cflags", "--libs"))
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        raise FFmpegUnavailable(
            "the video reader needs FFmpeg (libavformat, libavcodec, libavutil, "
            f"libswscale) found through pkg-config: {detail.strip()}") from e


def build(force: bool = False) -> str:
    """Path of the built library, compiling it unless it exists."""
    cflags, libs = ffmpeg_flags()
    digest = hashlib.sha256(" ".join(CXX_FLAGS + cflags + libs).encode())
    digest.update(SOURCE.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / "libvideodecoder.so"
    if lib.exists() and not force:
        return str(lib)
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", tmp, *cflags, *libs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building {SOURCE.name}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return str(lib)


if __name__ == "__main__":
    print(build(force=True))
