"""Port parity, the data layer: the synthetic imdbs (plain and hard), the
imdb factory, flipped augmentation, image reading, PASCAL VOC and COCO on
fabricated mini-datasets (built as ``tests/test_voc_coco.py`` builds them),
each against the JAX package. Everything is exact: roidbs field by field,
images byte for byte, evaluation results with ``==``.
"""

import numpy as np
import pytest

from aznet_tpu.data import coco as jcoco
from aznet_tpu.data import imdb as jimdb
from aznet_tpu.data import synthetic as jsyn
from aznet_tpu.data import voc as jvoc
from aznet_tpu_torch.data import coco as tcoco
from aznet_tpu_torch.data import imdb as timdb
from aznet_tpu_torch.data import synthetic as tsyn
from aznet_tpu_torch.data import voc as tvoc
from test_voc_coco import _make_coco, _make_voc


def _assert_roidbs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("hard,hw,n", [(False, (192, 256), 5), (True, (375, 500), 3)])
def test_synthetic_roidb_equal(hard, hw, n):
    got = tsyn.SyntheticImdb(split="test", seed=12, num_images=n, image_hw=hw, hard=hard)
    want = jsyn.SyntheticImdb(split="test", seed=12, num_images=n, image_hw=hw, hard=hard)
    assert (got.name, got.classes, got.num_classes, got.num_images) == (
        want.name, want.classes, want.num_classes, want.num_images)
    _assert_roidbs_equal(got.roidb, want.roidb)
    for g, w in zip(got.roidb, want.roidb):
        assert g["image"].tobytes() == w["image"].tobytes()
    for fn in ("make_image", "make_image_hard"):
        g, w = (getattr(m, fn)(np.random.RandomState(4)) for m in (tsyn, jsyn))
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_factory_equal():
    assert timdb.list_imdbs() == jimdb.list_imdbs()
    for name in ("synthetic_val", "synthetic_hard_test", "voc_2007_test", "coco_val2017"):
        got, want = timdb.get_imdb(name), jimdb.get_imdb(name)
        assert type(got).__name__ == type(want).__name__ and got.name == want.name
    got, want = timdb.get_imdb("synthetic_hard_test"), jimdb.get_imdb("synthetic_hard_test")
    assert (got.num_images, got.image_hw, got.hard, got.seed) == (
        want.num_images, want.image_hw, want.hard, want.seed)
    with pytest.raises(KeyError, match="unknown imdb"):
        timdb.get_imdb("nope")


def test_append_flipped_images_equal():
    got = tsyn.SyntheticImdb(split="train", seed=3, num_images=3)
    want = jsyn.SyntheticImdb(split="train", seed=3, num_images=3)
    got.append_flipped_images()
    want.append_flipped_images()
    _assert_roidbs_equal(got.roidb, want.roidb)
    for g, w in zip(got.roidb, want.roidb):
        np.testing.assert_array_equal(got.image_array(g), want.image_array(w))
    assert got.roidb[3]["flipped"] and got.image_array(got.roidb[3])[0, 0].tolist() == \
        got.roidb[0]["image"][0, -1].tolist()


@pytest.mark.parametrize("reader", ["cv2", "PIL"])
def test_pascal_voc_equal(tmp_path, monkeypatch, reader):
    if reader == "PIL":
        monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    monkeypatch.setenv("AZNET_DATA_DIR", str(tmp_path))
    _make_voc(tmp_path)
    assert tvoc.voc_data_available("2007") == jvoc.voc_data_available("2007") is True
    got = tvoc.PascalVOC("test", "2007", cache_dir=str(tmp_path / "tcache"))
    want = jvoc.PascalVOC("test", "2007", cache_dir=str(tmp_path / "jcache"))
    assert got.image_index == want.image_index and got.classes == want.classes
    _assert_roidbs_equal(got.roidb, want.roidb)
    for g, w in zip(got.roidb, want.roidb):
        np.testing.assert_array_equal(got.image_array(g), want.image_array(w))
    xml = str(tmp_path / "VOCdevkit2007" / "VOC2007" / "Annotations" / "000002.xml")
    for use_diff in (True, False):
        for g, w in zip(tvoc.parse_voc_xml(xml, use_diff), jvoc.parse_voc_xml(xml, use_diff)):
            np.testing.assert_array_equal(g, w)
    # Roidb cache round trip.
    _assert_roidbs_equal(tvoc.PascalVOC("test", "2007", cache_dir=str(tmp_path / "tcache")).roidb,
                         want.roidb)
    rng = np.random.RandomState(0)
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in range(2)] for _ in got.classes]
    for c in (7, 12, 15):  # car, dog, person
        for i in range(2):
            xy = rng.uniform(0, 300, (4, 2))
            all_boxes[c][i] = np.concatenate(
                [xy, xy + rng.uniform(20, 200, (4, 2)), rng.rand(4, 1)], 1).astype(np.float32)
    all_boxes[12][0][0] = [46, 238, 193, 369, 0.99]
    all_boxes[7][1][0] = [138, 199, 206, 300, 0.98]
    aps_g = got.evaluate_detections(all_boxes, str(tmp_path / "tres"))
    aps_w = want.evaluate_detections(all_boxes, str(tmp_path / "jres"))
    assert aps_g == aps_w and aps_g["dog"] > 0
    assert ((tmp_path / "tres" / "det_test_dog.txt").read_text()
            == (tmp_path / "jres" / "det_test_dog.txt").read_text())
    got.append_flipped_images()
    want.append_flipped_images()
    _assert_roidbs_equal(got.roidb, want.roidb)


def test_coco_equal(tmp_path, monkeypatch):
    monkeypatch.setenv("AZNET_DATA_DIR", str(tmp_path))
    _make_coco(tmp_path)
    assert tcoco.coco_data_available("val2017") and not tcoco.coco_data_available("x")
    got, want = tcoco.COCOImdb("val2017"), jcoco.COCOImdb("val2017")
    assert got.num_images == want.num_images == 2 and got.classes == want.classes
    _assert_roidbs_equal(got.roidb, want.roidb)
    all_boxes = [[np.zeros((0, 5), np.float32)] * 2,
                 [np.array([[10, 20, 59, 49, 0.9], [0, 0, 30, 30, 0.4]], np.float32),
                  np.array([[8, 8, 90, 90, 0.8]], np.float32)],
                 [np.array([[0, 0, 19, 19, 0.7]], np.float32), np.zeros((0, 5), np.float32)]]
    got_r = got.evaluate_detections(all_boxes, str(tmp_path))
    want_r = want.evaluate_detections(all_boxes, str(tmp_path))
    assert got_r.keys() == want_r.keys()
    for k in want_r:
        assert got_r[k] == want_r[k] or (np.isnan(got_r[k]) and np.isnan(want_r[k])), k
