# Ported from dmnerf_tpu/data/scannet_preprocess/sensordata.py (frames through utils/jpeg.py and utils/png.py, the nearest resize through data/scannet.py::nearest_index, in place of imageio and cv2; write_sens added).
"""ScanNet .sens binary parser + frame exporters.

Behavior parity with the reference's data/scannet/source_data/SensorData.py:
version-4 .sens layout (header: intrinsics/extrinsics for color+depth,
compression types, sizes, depth shift, frame count; per frame: c2w pose,
timestamps, jpeg color blob, zlib ushort depth blob). Exports color jpgs,
depth pngs (16-bit), per-frame pose txts, and intrinsic txts with the same
file layout the loaders consume. Streaming: frames are parsed lazily instead
of loading the whole multi-GB .sens into RAM. write_sens writes such a file.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np

from dmnerf_torch.data.scannet import nearest_index
from dmnerf_torch.utils.jpeg import read_jpeg, write_jpeg
from dmnerf_torch.utils.png import write_png

COMPRESSION_TYPE_COLOR = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
COMPRESSION_TYPE_DEPTH = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort",
                          2: "occi_ushort"}


class SensorData:
    def __init__(self, filename: str):
        self.filename = filename
        with open(filename, "rb") as f:
            version = struct.unpack("I", f.read(4))[0]
            assert version == 4, f"unsupported .sens version {version}"
            strlen = struct.unpack("Q", f.read(8))[0]
            self.sensor_name = f.read(strlen)
            self.intrinsic_color = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
            self.extrinsic_color = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
            self.intrinsic_depth = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
            self.extrinsic_depth = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
            self.color_compression = COMPRESSION_TYPE_COLOR[
                struct.unpack("i", f.read(4))[0]]
            self.depth_compression = COMPRESSION_TYPE_DEPTH[
                struct.unpack("i", f.read(4))[0]]
            self.color_width = struct.unpack("I", f.read(4))[0]
            self.color_height = struct.unpack("I", f.read(4))[0]
            self.depth_width = struct.unpack("I", f.read(4))[0]
            self.depth_height = struct.unpack("I", f.read(4))[0]
            self.depth_shift = struct.unpack("f", f.read(4))[0]
            self.num_frames = struct.unpack("Q", f.read(8))[0]
            self._frames_offset = f.tell()

    def iter_frames(self, frame_skip: int = 1
                    ) -> Iterator[Tuple[int, np.ndarray, bytes, bytes]]:
        """Yields (index, c2w_pose [4,4], color_blob, depth_blob)."""
        with open(self.filename, "rb") as f:
            f.seek(self._frames_offset)
            for i in range(self.num_frames):
                pose = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
                f.read(16)  # two uint64 timestamps
                color_sz = struct.unpack("Q", f.read(8))[0]
                depth_sz = struct.unpack("Q", f.read(8))[0]
                color = f.read(color_sz)
                depth = f.read(depth_sz)
                if i % frame_skip == 0:
                    yield i, pose, color, depth

    def decode_depth(self, blob: bytes) -> np.ndarray:
        assert self.depth_compression == "zlib_ushort", self.depth_compression
        raw = zlib.decompress(blob)
        return np.frombuffer(raw, np.uint16).reshape(self.depth_height,
                                                     self.depth_width)

    # --- exporters (same outputs as SensorData.py:72-112) ---

    def export_all(self, out_dir: str, frame_skip: int = 1,
                   image_size: Optional[Tuple[int, int]] = None):
        for sub in ("color", "depth", "pose"):
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        for i, pose, color, depth_blob in self.iter_frames(frame_skip):
            assert self.color_compression == "jpeg", self.color_compression
            img = read_jpeg(color)
            depth = self.decode_depth(depth_blob)
            if image_size is not None:      # cv2.resize(INTER_NEAREST)
                img = _nearest(img, *image_size)
                depth = _nearest(depth, *image_size)
            write_jpeg(os.path.join(out_dir, "color", f"{i}.jpg"), img)
            write_png(os.path.join(out_dir, "depth", f"{i}.png"), depth)
            np.savetxt(os.path.join(out_dir, "pose", f"{i}.txt"), pose, fmt="%f")
        self.export_intrinsics(os.path.join(out_dir, "intrinsic"))

    def export_intrinsics(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        for name, mat in (("intrinsic_color", self.intrinsic_color),
                          ("extrinsic_color", self.extrinsic_color),
                          ("intrinsic_depth", self.intrinsic_depth),
                          ("extrinsic_depth", self.extrinsic_depth)):
            np.savetxt(os.path.join(out_dir, f"{name}.txt"), mat, fmt="%f")


def _nearest(img: np.ndarray, H: int, W: int) -> np.ndarray:
    return img[nearest_index(img.shape[0], H)][:, nearest_index(img.shape[1], W)]


def write_sens(path: str, colors, depths, poses, intrinsic_color, intrinsic_depth,
               depth_shift: float = 1000.0, sensor_name: bytes = b"StructureSensor"):
    """A version-4 .sens file: colors are JPEG blobs (bytes) of one size,
    depths uint16 [h, w] (zlib-compressed here), poses c2w [4, 4]; the
    intrinsics are [4, 4] and the extrinsics the identity."""
    colors = list(colors)
    depths = [np.asarray(d, np.uint16) for d in depths]
    cH, cW = read_jpeg(colors[0]).shape[:2]
    dH, dW = depths[0].shape
    eye = np.eye(4, dtype=np.float32).tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<IQ", 4, len(sensor_name)) + sensor_name)
        f.write(np.asarray(intrinsic_color, np.float32).tobytes() + eye
                + np.asarray(intrinsic_depth, np.float32).tobytes() + eye)
        f.write(struct.pack("<iiIIIIfQ", 2, 1, cW, cH, dW, dH, depth_shift, len(colors)))
        for i, (color, depth, pose) in enumerate(zip(colors, depths, poses)):
            blob = zlib.compress(np.ascontiguousarray(depth).tobytes())
            f.write(np.asarray(pose, np.float32).tobytes())
            f.write(struct.pack("<QQQQ", i, i, len(color), len(blob)))
            f.write(color)
            f.write(blob)
