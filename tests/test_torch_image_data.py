"""The port's image reading and image dataset against the JAX package's
(CPU): ``read_image`` bit-equal on PNG and JPEG files, with and without the
resize + center crop, on non-square images; the decoder's errors (a JPEG
where the library was built without libjpeg, corrupt and unsupported
PNGs); ``ImageDatasetWithPrompts`` and ``batched`` item by item; and the
standalone CLIP-score CLI on the same weights."""

import json
from pathlib import Path

import numpy as np
import pytest

from sonicdiffusionbayeslab_torch import calc_clip_score as port_cli
from sonicdiffusionbayeslab_torch.data import _dataio
from sonicdiffusionbayeslab_torch.data.dataset import ImageDatasetWithPrompts, batched
from sonicdiffusionbayeslab_torch.data.imageio import encode_png_bytes, read_image
from sonicdiffusionbayeslab_tpu import calc_clip_score as jax_cli
from sonicdiffusionbayeslab_tpu.data import dataset as jds
from sonicdiffusionbayeslab_tpu.data.imageio import encode_png_bytes as jax_png
from sonicdiffusionbayeslab_tpu.data.imageio import read_image as jax_read_image

REPO = Path(__file__).resolve().parents[1]
ANNOTATIONS = REPO / "data" / "dataset" / "img2annotations_test.json"


def _pixels(h, w, seed):
    """Noise over a smooth ramp: the resize filters see both."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 255, w)[None, :, None] * np.linspace(0.3, 1, h)[:, None, None]
    return np.clip(ramp + rng.normal(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)


def _write(path, img, kind):
    """``kind``: "png" (the port's writer, libpng's row filters), "png_pil"
    (PIL's adaptive row filters), "rgba_pil", or "jpeg" (PIL, quality 90)."""
    if kind == "png":
        path.write_bytes(encode_png_bytes(img))
        return
    Image = pytest.importorskip("PIL.Image")
    if kind == "rgba_pil":
        Image.fromarray(np.dstack([img, img[..., :1]])).save(path, format="PNG")
    elif kind == "png_pil":
        Image.fromarray(img).save(path, format="PNG")
    else:
        Image.fromarray(img).save(path, format="JPEG", quality=90)


@pytest.mark.parametrize("size", [None, 24, 96])
@pytest.mark.parametrize("kind", ["png", "png_pil", "rgba_pil", "jpeg"])
def test_read_image_bit_equal_to_jax(tmp_path, kind, size):
    """Both shapes of a non-square image (wider and taller), named .jpg
    whatever the content: the decoder goes by content.  Downscale (24),
    upscale (96) and no resize all give JAX's exact bytes."""
    for i, (h, w) in enumerate(((40, 70), (70, 40))):
        p = tmp_path / f"img_{i}.jpg"
        _write(p, _pixels(h, w, i), kind)
        got, want = read_image(p, size), jax_read_image(p, size)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.shape == ((h, w, 3) if size is None else (size, size, 3))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (7, 1), (8, 8), (37, 53), (64, 64),
                                   (512, 512)])
@pytest.mark.parametrize("content", ["noise_ramp", "flat", "float"])
def test_png_bytes_equal_jax(shape, content):
    """The port's PNG writer gives the JAX package's bytes: each row's
    filter, the zlib window of images under 16 KiB and the 8192-byte IDAT
    chunks of large ones (512^2), single rows and columns included."""
    h, w = shape
    if content == "noise_ramp":
        img = _pixels(h, w, h * 1000 + w)
    elif content == "flat":
        img = np.full((h, w, 3), 17, np.uint8)
    else:
        img = np.random.default_rng(h + w).random((h, w, 3), dtype=np.float32)
    png = encode_png_bytes(img)
    assert png == jax_png(img)
    np.testing.assert_array_equal(
        _decoded(png), np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
        if content == "float" else img)


def _decoded(png):
    """The pixels of PNG bytes, read back by the port's decoder."""
    from sonicdiffusionbayeslab_torch.data.imageio import _decode

    return _decode(png, "a test PNG")


def test_jpeg_without_libjpeg_names_the_library(tmp_path, monkeypatch):
    """A build where jpeglib.h is not found (a machine without libjpeg's
    headers) decodes PNGs all the same and raises on a JPEG, naming
    libjpeg."""
    pytest.importorskip("PIL.Image")
    monkeypatch.setattr(_dataio, "_has_header", lambda name: False)
    monkeypatch.setattr(_dataio, "_lib", None)
    assert not _dataio.library().sdbl_has_jpeg()
    img = _pixels(20, 30, 3)
    _write(tmp_path / "a.png", img, "png_pil")
    np.testing.assert_array_equal(read_image(tmp_path / "a.png"), img.astype(np.float32) / 255.0)
    _write(tmp_path / "b.jpg", img, "jpeg")
    with pytest.raises(RuntimeError, match="libjpeg"):
        read_image(tmp_path / "b.jpg")


def test_decoder_errors_name_the_fault(tmp_path):
    data = bytearray(encode_png_bytes(_pixels(8, 8, 4)))
    data[-20] ^= 0xFF  # inside IDAT: its CRC no longer matches
    (tmp_path / "bad.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        read_image(tmp_path / "bad.png")
    (tmp_path / "x.txt").write_bytes(b"not an image")
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        read_image(tmp_path / "x.txt")
    Image = pytest.importorskip("PIL.Image")
    Image.fromarray(_pixels(8, 8, 5)[..., 0]).save(tmp_path / "gray.png")
    with pytest.raises(ValueError, match="PNG variant"):
        read_image(tmp_path / "gray.png")


def _image_dir(tmp_path, n=3):
    files = sorted(json.loads(ANNOTATIONS.read_text()))[:n]
    for i, f in enumerate(files):
        (tmp_path / f).write_bytes(encode_png_bytes(_pixels(30 + 10 * i, 50 - 5 * i, i)))
    return files


def test_image_dataset_items_equal_jax(tmp_path):
    files = _image_dir(tmp_path)
    port = ImageDatasetWithPrompts(tmp_path, ANNOTATIONS, image_size=32, max_count=3)
    ref = jds.ImageDatasetWithPrompts(tmp_path, ANNOTATIONS, image_size=32, max_count=3)
    assert port.files == ref.files == files
    for i in range(3):
        a, b = port[i], ref[i]
        assert a.keys() == b.keys() == {"image_file", "prompt", "index", "image"}
        assert (a["image_file"], a["prompt"], a["index"]) == (b["image_file"], b["prompt"],
                                                              b["index"])
        np.testing.assert_array_equal(a["image"], b["image"])
    got, want = list(batched(port, 2)), list(jds.batched(ref, 2))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["index"], b["index"])
        assert a["prompt"] == b["prompt"] and a["image_file"] == b["image_file"]
    assert got[0]["image"].shape == (2, 32, 32, 3)


def test_image_dataset_missing_files_raise_like_jax(tmp_path):
    _image_dir(tmp_path, n=2)
    msgs = []
    for cls in (ImageDatasetWithPrompts, jds.ImageDatasetWithPrompts):
        with pytest.raises(FileNotFoundError, match="1 of 3 dataset images missing") as e:
            cls(tmp_path, ANNOTATIONS, image_size=32, max_count=3)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_calc_clip_score_cli_matches_jax(tmp_path, capsys):
    """The same tiny CLIP snapshot in both CLIs, on a folder of images at
    their own (equal) size and resized to 24: scores within 1e-3."""
    from test_torch_clip import _clip_snapshot, dual_pair

    _, params, _, _ = dual_pair("tiny", seed=7)
    (tmp_path / "clip").mkdir()
    snap = _clip_snapshot(tmp_path / "clip", params)
    files = sorted(json.loads(ANNOTATIONS.read_text()))[:3]
    for i, f in enumerate(files):
        (tmp_path / f).write_bytes(encode_png_bytes(_pixels(40, 48, 10 + i)))
    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps({f: json.loads(ANNOTATIONS.read_text())[f] for f in files}))
    for size in (None, 24):
        got = port_cli.calc_clip_score(str(tmp_path), str(prompts), 2, snap, size, tiny=True,
                                       device="cpu")
        want = jax_cli.calc_clip_score(str(tmp_path), str(prompts), 2, snap, size, tiny=True)
        assert 0.0 <= got <= 100.0 and abs(got - want) <= 1e-3
    port_cli.main(["--folder_path", str(tmp_path), "--prompts_file", str(prompts), "--model", snap,
                   "--tiny", "--device", "cpu"])
    assert capsys.readouterr().out.startswith("CLIP score: ")
