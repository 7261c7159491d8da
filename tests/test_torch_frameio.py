"""The port's frame reader (`utils/frameio.py::VideoSource`, the native
mmap reader of native/frameio.cpp built with g++ at first use) against
its plain NumPy version, and streaming fed by it.

The native code scales uint8 by `1.0f / 255`, NumPy divides by 255: in
float32 the two differ by an ulp for 126 of the 256 byte values, and
`floor(x * 255)` (what `prepare_frames` does) gives every byte back with
both, so the bytes are what the tests hold."""

import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu_torch.pipeline.streaming import process_streaming
from comfyui_propainter_nodes_tpu_torch.utils import frameio
from test_torch_streaming import moving_box_clip, port_pipeline

torch.set_num_threads(1)


def all_bytes_video(dtype):
    """[4, 8, 8, 3]: every byte value once per channel, as uint8 or as
    float32 bytes / 255."""
    u8 = np.arange(4 * 8 * 8 * 3, dtype=np.int64).reshape(4, 8, 8, 3) % 256
    u8 = u8.astype(np.uint8)
    return u8, (u8 if dtype == np.uint8 else (u8 / np.float32(255)).astype(np.float32))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_fetch_gives_the_plain_readers_bytes(tmp_path, dtype):
    u8, video = all_bytes_video(dtype)
    path = str(tmp_path / "video.npy")
    np.save(path, video)
    with frameio.VideoSource(path) as src:
        assert src.shape == video.shape and src.num_frames == 4
        got = src.fetch(0, 4)
    plain = frameio.read_frames_plain(path, 0, 4)
    assert got.dtype == np.float32 and got.shape == video.shape
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_array_equal(np.floor(got * 255), np.floor(plain * 255))
    np.testing.assert_array_equal(np.floor(got * 255), u8)


@pytest.mark.parametrize("start,count", [(2, 5), (-3, 4), (-2, 9), (4, 2)])
def test_out_of_range_frames_clamp(tmp_path, start, count):
    """Past the end the last frame repeats; a negative start reads frame 0."""
    u8, video = all_bytes_video(np.uint8)
    path = str(tmp_path / "video.npy")
    np.save(path, video)
    with frameio.VideoSource(path) as src:
        got = src.fetch(start, count)
    idx = np.clip(np.arange(start, start + count), 0, 3)
    np.testing.assert_array_equal(np.floor(got * 255), u8[idx])
    np.testing.assert_array_equal(np.floor(frameio.read_frames_plain(path, start, count) * 255), u8[idx])


def test_prefetch_then_close_twice(tmp_path):
    _, video = all_bytes_video(np.uint8)
    path = str(tmp_path / "video.npy")
    np.save(path, video)
    src = frameio.VideoSource(path)
    src.prefetch(1, 3)
    assert src.fetch(3, 1).shape == (1, 8, 8, 3)
    src.close()
    src.close()
    with pytest.raises(ValueError, match="closed"):
        src.fetch(0, 1)


@pytest.mark.parametrize(
    "make",
    [
        lambda v: v.astype(np.float64),
        lambda v: np.asfortranarray(v),
        lambda v: v[..., 0],
        lambda v: v.astype(">f4"),
    ],
    ids=["float64", "fortran", "3d", "big_endian"],
)
def test_files_the_reader_does_not_take_raise(tmp_path, make):
    _, video = all_bytes_video(np.float32)
    path = str(tmp_path / "video.npy")
    np.save(path, make(video))
    with pytest.raises(ValueError, match="takes a C-order"):
        frameio.VideoSource(path)


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        frameio.VideoSource(str(tmp_path / "none.npy"))


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "frameio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(frameio, "SOURCE", str(bad))
    monkeypatch.setattr(frameio, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(frameio, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        frameio.library()


def test_library_is_named_by_its_source():
    path = frameio.build()
    assert path.startswith(frameio.BUILD_DIR) and path == frameio.build()


def test_streaming_from_the_reader_equals_streaming_from_arrays(tmp_path):
    t, h, w = 10, 32, 48
    frames, masks = moving_box_clip(t, h, w)
    frames_u8 = np.floor(frames * 255).astype(np.uint8)
    masks_u8 = (masks[..., None] * 255).astype(np.uint8)
    np.save(tmp_path / "frames.npy", frames_u8)
    np.save(tmp_path / "masks.npy", masks_u8)
    widgets = dict(ref_stride=3, neighbor_length=6, subvideo_length=4, raft_iter=1, fp16="disable")
    pipe = port_pipeline(widgets, h, w)

    def run(fetch, fetch_mask, prefetch=None):
        out = np.zeros((t, h, w, 3), np.float32)

        def write(start, arr):
            out[start : start + arr.shape[0]] = arr

        process_streaming(pipe, fetch, fetch_mask, t, write, 2, 2, prefetch=prefetch)
        return out

    with frameio.VideoSource(str(tmp_path / "frames.npy")) as fsrc, frameio.VideoSource(
        str(tmp_path / "masks.npy")
    ) as msrc:
        from_reader = run(fsrc.fetch, lambda s, c: msrc.fetch(s, c)[..., 0], fsrc.prefetch)
    from_arrays = run(
        lambda s, c: frames_u8[s : s + c] / np.float32(255), lambda s, c: masks_u8[s : s + c, ..., 0] / np.float32(255)
    )
    np.testing.assert_array_equal(from_reader, from_arrays)
