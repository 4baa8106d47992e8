"""Image output — the swapchain/present analogue. The reference presents
frames to a window via the Vulkan swapchain (VulkanSwapchain.cpp:39-70);
on a headless accelerator host the equivalent is writing frames to disk.
Pure-stdlib PNG encoder (zlib deflate, filter 0) — no external image dependency.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["to_uint8", "encode_png", "write_png", "write_ppm"]


def to_uint8(img):
    """float image in [0,1] (H, W, {1,3,4}) -> uint8, with clamping (the
    GPU's implicit unorm conversion on present)."""
    arr = np.asarray(img, dtype=np.float32)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(img, level: int = 6) -> bytes:
    """Encode an image to PNG bytes. img: uint8 or float (H, W) /
    (H, W, C) with C in {1, 3, 4}. level: zlib compression (the live
    serve mode uses a low level — encode latency is frame latency)."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]

    raw = b"".join(b"\x00" + arr[row].tobytes() for row in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", ihdr)
        + _png_chunk(b"IDAT", zlib.compress(raw, level))
        + _png_chunk(b"IEND", b"")
    )


def write_png(path, img):
    """Write an image to PNG. img: uint8 or float (H, W) / (H, W, C) with
    C in {1, 3, 4}."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
    return path


def write_ppm(path, img):
    """Fast uncompressed PPM (P6) writer for high-frame-rate dumps."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    if arr.shape[2] == 4:
        arr = arr[:, :, :3]
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(arr.tobytes())
    return path


class AsyncFrameWriter:
    """Pipelined frame presentation: PNG encodes/writes run on a small
    thread pool so the render loop never blocks on disk — the headless
    analogue of the reference's frames-in-flight present queue
    (MAX_FRAMES_IN_FLIGHT=2, VulkanRenderer.cpp:13: the GPU renders frame
    N+1 while frame N is presented). zlib/file IO release the GIL, so
    threads give real overlap. Use as a context manager; exit joins all
    pending writes and re-raises the first failure."""

    def __init__(self, workers: int = 2):
        from concurrent.futures import ThreadPoolExecutor
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="frame-writer")
        self._pending = []

    def write(self, path, img):
        """img must be host data (np.asarray any device array first)."""
        arr = np.asarray(img)
        self._pending.append(self._pool.submit(write_png, path, arr))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        errs = [f.exception() for f in self._pending]
        self._pool.shutdown(wait=True)
        self._pending.clear()
        # A failure in the with-body (e.g. a mid-animation render error)
        # is the primary error: never mask it with a secondary disk
        # error — log writer failures and let the body's exception
        # propagate; raise them only on a clean exit.
        for e in errs:
            if e is not None:
                if exc_val is not None:
                    from .metrics import get_logger
                    get_logger().error(
                        "pending frame write also failed: %s: %s",
                        type(e).__name__, e)
                    return False
                raise e
        return False
