"""The port's entry points that take a ``device`` run on the card unless the
caller asks for the CPU: without a GPU, a call that names no device raises
a clear error instead of running the plain versions quietly, and
``device="cpu"`` still runs them."""
import cv2
import numpy as np
import pytest
import torch

from reflectance_filtering_tpu_torch.cli import filter as tfilt
from reflectance_filtering_tpu_torch.ops import bilateral as tbil
from reflectance_filtering_tpu_torch.ops import guided as tg


def _images(rng):
    photo = np.floor(rng.rand(12, 14, 3) * 256).astype(np.uint8)
    refl = np.repeat(photo[..., :1], 3, axis=-1)
    return photo, refl


def _calls(tmp_path, photo, refl):
    """name -> (the entry point, its positional arguments)."""
    photo_png, refl_png = str(tmp_path / "p.png"), str(tmp_path / "p-r.png")
    cv2.imwrite(photo_png, photo)
    cv2.imwrite(refl_png, refl)
    return {
        "joint_bilateral_filter_u8": (tbil.joint_bilateral_filter_u8,
                                      (refl, refl, -1, 20.0, 3.0)),
        "guided_filter_u8": (tg.guided_filter_u8, (photo, refl, 3, 3.0)),
        "fast_guided_filter_u8": (tg.fast_guided_filter_u8,
                                  (photo, refl, 4, 3.0, 2)),
        "apply_filter": (tfilt.apply_filter,
                         ("bilateral", refl, photo, 20.0, 3.0)),
        "read_filter_write": (tfilt.read_filter_write,
                              ("guided", refl_png, photo_png, 3.0, 3.0,
                               str(tmp_path))),
    }


@pytest.mark.parametrize("name", ["joint_bilateral_filter_u8",
                                  "guided_filter_u8", "fast_guided_filter_u8",
                                  "apply_filter", "read_filter_write"])
def test_entry_point_defaults_to_the_card(name, rng, tmp_path, monkeypatch):
    photo, refl = _images(rng)
    fn, args = _calls(tmp_path, photo, refl)[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available.*"
                                           "device='cpu'"):
        fn(*args)
    out = fn(*args, device="cpu")
    assert out.dtype == np.uint8 and out.shape == refl.shape
