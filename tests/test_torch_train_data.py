"""The port's identity-folder dataset (train/data.py) against the JAX
package's on the same folder.

Without a detector (letterbox crops): the classes, samples and labels
equal, and every batch bit-equal, with and without augmentation, over
two epochs. With a detector (both packages load the same `.npz`, biased
to find faces on the noise images, gather warp, float32): the same
faces give crops within 1 of each other per pixel (uint8 truncation of
values the two warps compute in other float32 orders), and the port's
crop is the port's `align_faces` of its own detection, exactly.
"""

import numpy as np
import pytest
import torch

from chip_smoke import png_bytes
from facerecognizeonnx_tpu.config import PipelineConfig as JaxConfig
from facerecognizeonnx_tpu.pipeline.api import FaceDetector as JaxDetector
from facerecognizeonnx_tpu.train.data import IdentityFolderDataset as JaxDataset
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.embed.pipeline import align_faces
from facerecognizeonnx_tpu_torch.io.imageio import imread
from facerecognizeonnx_tpu_torch.pipeline.api import FaceDetector
from facerecognizeonnx_tpu_torch.runtime.native import letterbox_native
from facerecognizeonnx_tpu_torch.train.data import IdentityFolderDataset
from facerecognizeonnx_tpu_torch.types import face_boxes_to_arrays
from tests.test_torch_app import seeded_weights


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """ann/ben/cy with 3, 3 and 1 images (128×128 noise PNGs), a .txt
    that is not an image, and an empty directory."""
    root = tmp_path_factory.mktemp("ids")
    rng = np.random.default_rng(13)
    images = []
    for who, n in (("ann", 3), ("ben", 3), ("cy", 1)):
        (root / who).mkdir()
        for i in range(n):
            img = rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)
            (root / who / f"{i}.png").write_bytes(png_bytes(img[..., ::-1].copy()))
            images.append(img)
    (root / "ann" / "notes.txt").write_text("not an image")
    (root / "empty").mkdir()
    return root, images


@pytest.mark.parametrize("min_images", [1, 2])
def test_listing_and_labels_equal(folder, min_images):
    root, _ = folder
    got = IdentityFolderDataset(str(root), min_images_per_id=min_images)
    want = JaxDataset(str(root), min_images_per_id=min_images)
    assert got.classes == want.classes and got.samples == want.samples
    assert got.num_classes == want.num_classes and len(got) == len(want)


@pytest.mark.parametrize("augment", [False, True])
def test_batches_bit_equal(folder, augment):
    root, _ = folder
    got = IdentityFolderDataset(str(root)).batches(3, seed=4, epochs=2, augment=augment)
    want = JaxDataset(str(root)).batches(3, seed=4, epochs=2, augment=augment)
    n = 0
    for (gx, gy), (wx, wy) in zip(got, want, strict=True):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert gx.dtype == np.float32 and gy.dtype == np.int32
        n += 1
    assert n == 4  # 7 images: two full batches an epoch


def test_detector_crops(folder):
    root, images = folder
    det_path, _ = seeded_weights(root, np.stack([letterbox_native(im, 128)[0] for im in images]))
    cfg = PipelineConfig(det_input_size=128, compute_dtype="float32", warp_impl="gather")
    det = FaceDetector(cfg, device="cpu")
    jdet = JaxDetector(JaxConfig(det_input_size=128, compute_dtype="float32",
                                 warp_impl="gather"))
    assert det.load_model(det_path) and jdet.load_model(det_path)
    got = IdentityFolderDataset(str(root), detector=det, cfg=cfg)
    want = JaxDataset(str(root), detector=jdet, cfg=jdet.cfg)
    for path, _ in got.samples[:4]:
        crop, ref = got.crop(path), want.crop(path)
        assert crop.shape == (112, 112, 3) and crop.dtype == np.uint8
        assert np.abs(crop.astype(np.int16) - ref.astype(np.int16)).max() <= 1
        faces = det.detect(imread(path))
        assert faces, "the biased detector finds a face"
        dets = face_boxes_to_arrays(faces[:1], 1)
        direct = align_faces(torch.from_numpy(imread(path)), dets.kps, dets.boxes, cfg)[0]
        np.testing.assert_array_equal(crop, direct.numpy().astype(np.uint8))
        assert got.crop(path) is crop  # cached
