"""PyTorch port, the int8 trunk (``models/quantize.py``) against the JAX
package's on the CPU.

Inputs come from numpy seeds: the VGG16 trunk He-normal with small biases,
ResNet-152 and Inception-v3 from ``test_torch_port_encoders.fake_torchvision``
(random BatchNorm statistics, so that the folding does something), images
standard normal as the JAX suite's ``_images``. Each trunk runs at full
depth on 2 images (64 px, 96 px for Inception-v3); its JAX calibration and
JAX int8 features are built once per module (``_trunk``). The JAX int8
trunk runs eagerly, as ``tests/test_quantize.py`` runs it, but for
Inception-v3's, which runs under ``jax.jit``: eagerly its convolutions
compile one by one (~19 s here), and the port's features stand as close to
either (0 and 7.4e-8 of scale).

What is held, and how closely (``tests/torch_port_parity.py`` prints it):
- one int8 conv from the same x and tree, per geometry of the three trunks:
  the int32 accumulators equal, the fp32 output equal (XLA on the CPU does
  not contract the epilogue into an FMA here: 0 ulp);
- ``wq``, ``sw`` and ``b`` from the same float trunk: ``torch.equal``;
- ``sx``: within ``SX_RTOL`` relative. The scales come from a float replay
  of the trunk, whose fp32 convs round differently in the two frameworks
  (measured up to 1.47e-6);
- the port's int8 trunk over the JAX package's calibrated tree (carried by
  ``ckpt.convert.from_jax_quantized``, or read from a file the JAX package
  wrote): within ``FEATURE_RTOL`` of the JAX features' scale (measured 0
  for VGG16 and Inception-v3, 7.1e-8 for ResNet-152, where the float 7x7
  stem rounds differently);
- the port's own calibration against its fp32 trunk: the JAX suite's
  cosine thresholds.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_encoders as tpe
from show_and_tell_tpu.models import encoders as jenc
from show_and_tell_tpu.models import quantize as jq
from show_and_tell_tpu_torch.ckpt.convert import from_jax_quantized
from show_and_tell_tpu_torch.models import encoders as tenc
from show_and_tell_tpu_torch.models import quantize as tq
from show_and_tell_tpu_torch.models.layers import batch_norm_inference, conv2d

SX_RTOL = 5e-6  # activation scales from the two float replays
FEATURE_RTOL = 1e-6  # int8 trunk features from one tree, max |diff| / max |JAX feature|
SIZES = {"vgg16": 64, "resnet152": 64, "inception_v3": 96}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The file's tiny convolutions and steps on one thread: under a
    parallel test run, more only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def images(n=4, size=64, seed=0):
    """The JAX suite's ``_images``: image-like statistics after the
    normalisation, as numpy."""
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def vgg_tree(seed=0):
    """A JAX-layout VGG16 trunk: He-normal HWIO kernels, biases N(0, 0.05)."""
    rng = np.random.default_rng(seed)
    convs, cin = [], 3
    for ch in jenc._VGG_CHANNELS:
        if ch == "M":
            continue
        convs.append({"w": rng.normal(0, np.sqrt(2 / (9 * cin)), (3, 3, cin, ch)).astype(np.float32),
                      "b": rng.normal(0, 0.05, ch).astype(np.float32)})
        cin = ch
    return {"convs": convs}


def jax_tree(name, seed=0):
    return vgg_tree(seed) if name == "vgg16" else tpe.jax_trunk(name, tpe.fake_torchvision(name, seed))


@functools.lru_cache(maxsize=None)
def _trunk(name):
    """The JAX trunk, the same trunk in the port, 2 calibration images, the
    JAX calibration and its int8 features, and the port's calibration."""
    jtree = jax_tree(name)
    ttree = tpe.port_model_trunk(name, jtree)
    x = images(2, SIZES[name])
    jq_tree = jq.quantize_backbone(name, jtree, jnp.asarray(x))
    forward = jax.jit(jq.backbone_features_q) if name == "inception_v3" else jq.backbone_features_q
    return {"jtree": jtree, "ttree": ttree, "x": x, "jq": jq_tree,
            "jfeat": np.asarray(forward(jq_tree, jnp.asarray(x))),
            "tq": tq.quantize_backbone(name, ttree, torch.from_numpy(x))}


def leaves(a, b, path=""):
    """(path, a leaf, b leaf) of two trees of the same keys."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            yield from leaves(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from leaves(x, y, f"{path}.{i}")
    else:
        yield path, a, b


def rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max() / np.abs(want).max())


# --- one int8 conv ----------------------------------------------------------------

# every int8 conv geometry of the three trunks: (kh, kw, stride, (ph, pw))
GEOMETRIES = [(3, 3, 1, (1, 1)), (3, 3, 2, (0, 0)), (3, 3, 1, (0, 0)), (1, 1, 1, (0, 0)), (1, 1, 2, (0, 0)),
              (1, 7, 1, (0, 3)), (7, 1, 1, (3, 0)), (1, 3, 1, (0, 1)), (3, 1, 1, (1, 0)), (5, 5, 1, (2, 2))]


def _conv_case(kh, kw, seed, ci=16, co=24, hw=(9, 11), n=2):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.2, (kh, kw, ci, co)).astype(np.float32)
    b = rng.normal(0, 0.3, co).astype(np.float32)
    x = rng.normal(0, 1, (n, *hw, ci)).astype(np.float32)
    return jq._quant_folded({"w": w, "b": b}, float(np.abs(x).max()) * 1.1 / 127), x


def _port_conv(tree, x, stride, pad):
    y = tq._qconv_s(tree, torch.from_numpy(x).permute(0, 3, 1, 2), stride=stride, padding=pad)
    assert y.dtype == torch.float32
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("kh,kw,stride,pad", GEOMETRIES, ids=lambda v: str(v).replace(" ", ""))
def test_qconv_matches_jax(kh, kw, stride, pad):
    """The int32 accumulators equal (read through scales of 2^-3 and 2^3,
    whose product is 1, and a zero bias), and the fp32 output of the
    calibrated conv equal, bit for bit."""
    jtree, x = _conv_case(kh, kw, seed=kh * 10 + kw + stride)
    jpad = [(pad[0], pad[0]), (pad[1], pad[1])]
    unit = dict(jtree, sx=jnp.float32(0.125), sw=jnp.full(jtree["sw"].shape, 8.0, jnp.float32),
                b=jnp.zeros(jtree["b"].shape, jnp.float32))
    xq = jnp.clip(jnp.round(jnp.asarray(x) / unit["sx"]), -127, 127).astype(jnp.int8)
    acc = np.asarray(jax.lax.conv_general_dilated(xq, unit["wq"], (stride, stride), jpad,
                                                  dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                                  preferred_element_type=jnp.int32))
    got = _port_conv(from_jax_quantized(unit), x, stride, pad)
    assert np.abs(acc).max() < 2 ** 24 and np.array_equal(got.astype(np.int64), acc.astype(np.int64))
    want = np.asarray(jq._qconv_s(jtree, jnp.asarray(x), stride=stride, padding=jpad))
    got = _port_conv(from_jax_quantized(jtree), x, stride, pad)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_qconv_chunks_and_short_gemms(monkeypatch):
    """Chunks of one image give the one-chunk output bit for bit; a GEMM of
    at most 16 rows is padded (and counted), its output the same."""
    jtree, x = _conv_case(3, 3, seed=5, hw=(5, 6), n=3)
    tree = from_jax_quantized(jtree)
    whole = _port_conv(tree, x, 1, (1, 1))
    monkeypatch.setattr(tq, "_IM2COL_BYTES", 5 * 6 * 9 * 16)
    before = dict(tq.GEMMS)
    assert np.array_equal(_port_conv(tree, x, 1, (1, 1)), whole)
    assert tq.GEMMS["int_mm"] - before.get("int_mm", 0) == 3
    jtree, x = _conv_case(1, 1, seed=6, hw=(2, 3), n=2)  # 12 rows
    want = np.asarray(jq._qconv_s(jtree, jnp.asarray(x)))
    before = tq.GEMMS["padded"]
    assert np.array_equal(_port_conv(from_jax_quantized(jtree), x, 1, (0, 0)), want)
    assert tq.GEMMS["padded"] == before + 1


def test_qconv_never_falls_back_to_a_float_conv(monkeypatch):
    """A K or N that the int8 GEMM does not take raises, and so does a failed
    GEMM: no float conv stands in for a quantized layer."""
    jtree, x = _conv_case(1, 1, seed=7, ci=12)
    with pytest.raises(ValueError, match="multiples of 8"):
        _port_conv(from_jax_quantized(jtree), x, 1, (0, 0))

    def broken(a, b):
        raise RuntimeError("int8 GEMM failed")

    monkeypatch.setattr(torch, "_int_mm", broken)
    jtree, x = _conv_case(3, 3, seed=8)
    with pytest.raises(RuntimeError, match="int8 GEMM failed"):
        _port_conv(from_jax_quantized(jtree), x, 1, (1, 1))


# --- weights and scales --------------------------------------------------------------


@pytest.mark.parametrize("name", ["vgg16", "resnet152", "inception_v3"])
def test_weights_and_scales_match_jax(name):
    """From the same float trunk: every ``wq``, ``sw`` and ``b`` equal to
    JAX's, bit for bit; every ``sx`` within SX_RTOL; the float first conv
    carried over; the tree's keys JAX's."""
    t = _trunk(name)
    want = from_jax_quantized(t["jq"])
    n = worst = 0
    for path, w, g in leaves(want, t["tq"]):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if path.endswith(".sx"):
            worst = max(worst, abs(float(g) - float(w)) / float(w))
        else:
            assert torch.equal(g, w), path
        n += path.endswith(".wq")
    assert worst <= SX_RTOL, worst
    assert n == {"vgg16": 11, "resnet152": 154, "inception_v3": 93}[name]


def test_bn_folding_exact():
    """The folded conv against conv + BatchNorm in fp32 (the JAX suite's
    bound), and the fold itself equal to JAX's bit for bit."""
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.1, (3, 3, 16, 32)).astype(np.float32)
    bn = {"scale": rng.uniform(0.5, 1.5, 32), "bias": rng.normal(0, 0.2, 32), "mean": rng.normal(0, 0.3, 32),
          "var": rng.uniform(0.5, 2.0, 32)}
    bn = {k: v.astype(np.float32) for k, v in bn.items()}
    tconv = {"w": torch.from_numpy(w).permute(3, 2, 0, 1)}
    tbn = {k: torch.from_numpy(v) for k, v in bn.items()}
    x = torch.from_numpy(rng.standard_normal((2, 16, 8, 8)).astype(np.float32))
    want = batch_norm_inference(tbn, conv2d(tconv, x, padding=1).permute(0, 2, 3, 1))
    folded = tq._fold_conv_bn(tconv, tbn)
    got = conv2d(folded, x, padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    jfold = jq._fold_conv_bn({"w": w}, bn)
    assert torch.equal(folded["w"], torch.from_numpy(jfold["w"]).permute(3, 2, 0, 1))
    assert torch.equal(folded["b"], torch.from_numpy(jfold["b"]))


# --- whole trunks ---------------------------------------------------------------------


@pytest.mark.parametrize("name", ["vgg16", "resnet152", "inception_v3"])
def test_trunk_from_jax_tree_matches_jax(name):
    """The port's int8 trunk over the JAX package's calibrated tree: fp32
    features of JAX's shape within FEATURE_RTOL of them."""
    t = _trunk(name)
    got = tq.backbone_features_q(from_jax_quantized(t["jq"]), torch.from_numpy(t["x"]))
    assert got.dtype == torch.float32 and got.shape == t["jfeat"].shape
    assert rel(t["jfeat"], got.numpy()) <= FEATURE_RTOL


def test_jax_written_calibration_file_reads_into_the_port(tmp_path):
    """A file of the JAX package's ``save_quantized`` (flax msgpack), told
    from the port's own by its content: the port's features from it equal
    those from JAX's tree, and a wrong-architecture guard fires on it."""
    t = _trunk("inception_v3")
    path = str(tmp_path / "jax.int8")
    jq.save_quantized(path, t["jq"])
    q = tq.load_quantized(path)
    assert tq._quantized_kind(q) == "inception_v3"
    want = tq.backbone_features_q(from_jax_quantized(t["jq"]), torch.from_numpy(t["x"]))
    assert torch.equal(tq.backbone_features_q(q, torch.from_numpy(t["x"])), want)
    with pytest.raises(ValueError, match="calibrated for inception_v3"):
        tq.obtain_quantized("resnet152", t["ttree"], torch.from_numpy(t["x"]), path=path)


# --- mirrors of tests/test_quantize.py ------------------------------------------------


def _vgg():
    return tpe.port_model_trunk("vgg16", vgg_tree(seed=0))


def test_quantized_features_close_to_f32():
    frozen = _vgg()
    imgs = torch.from_numpy(images())
    q = tq.quantize_vgg16(frozen, imgs)
    assert tq.is_quantized(q) and not tq.is_quantized(frozen)
    f = tenc.vgg16_features(frozen, imgs)
    g = tq.vgg16_features_q(q, imgs)
    assert f.shape == g.shape
    cos = tq.feature_agreement(frozen, q, imgs)
    assert cos > 0.98, cos
    imgs2 = torch.from_numpy(images(seed=7))
    assert torch.isfinite(tq.vgg16_features_q(q, imgs2)).all()
    cos2 = tq.feature_agreement(frozen, q, imgs2)
    assert cos2 > 0.97, cos2


def test_quantized_weight_layout():
    frozen = _vgg()
    q = tq.quantize_vgg16(frozen, torch.from_numpy(images(n=2)))
    assert len(q["qconvs"]) == len(frozen["convs"]) - 1  # conv0 stays float
    assert torch.equal(q["conv0"]["w"], frozen["convs"][0]["w"])
    for qc, conv in zip(q["qconvs"], frozen["convs"][1:]):
        w = conv["w"].permute(2, 3, 1, 0)  # HWIO
        assert qc["wq"].dtype == torch.int8 and qc["wq"].shape == w.shape
        assert qc["sw"].shape == (w.shape[-1],)  # per output channel
        assert qc["sx"].dtype == torch.float32 and qc["sx"].dim() == 0
        # the GEMM reads the weight in place
        assert tq._gemm_weight(qc["wq"]).data_ptr() == qc["wq"].data_ptr()
        deq = qc["wq"].float() * qc["sw"]
        np.testing.assert_allclose(deq.numpy(), w.numpy(), atol=float(qc["sw"].max()))


def _randomize_bn(bn, rng):
    return {"scale": torch.from_numpy(rng.uniform(0.5, 1.5, bn["scale"].shape).astype(np.float32)),
            "bias": torch.from_numpy(rng.normal(0, 0.2, bn["bias"].shape).astype(np.float32)),
            "mean": torch.from_numpy(rng.normal(0, 0.3, bn["mean"].shape).astype(np.float32)),
            "var": torch.from_numpy(rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32))}


def test_resnet152_quantized_features_close():
    rng = np.random.default_rng(0)
    frozen = tenc.init_resnet152(torch.Generator().manual_seed(0))
    frozen["stem_bn"] = _randomize_bn(frozen["stem_bn"], rng)
    for blocks in frozen["layers"]:
        for blk in blocks:
            for k in list(blk):
                if k.startswith("bn") or k == "down_bn":
                    blk[k] = _randomize_bn(blk[k], rng)
    imgs = torch.from_numpy(images(n=2))
    q = tq.quantize_resnet152(frozen, imgs)
    assert tq.is_quantized(q)
    f = tenc.resnet152_features(frozen, imgs)
    g = tq.resnet152_features_q(q, imgs)
    assert f.shape == g.shape == (2, 2048) and torch.isfinite(g).all()
    cos = tq._cosine(f.numpy(), g.numpy())
    assert cos > 0.95, cos


def test_quantized_tree_save_load_roundtrip(tmp_path):
    frozen = tpe.port_model_trunk("vgg16", vgg_tree(seed=2))
    imgs = torch.from_numpy(images(n=2))
    q = tq.quantize_vgg16(frozen, imgs)
    p = str(tmp_path / "backbone.int8.pt")
    tq.save_quantized(p, q)
    assert not os.path.exists(p + ".tmp")  # written atomically
    q2 = tq.load_quantized(p)
    assert tq.is_quantized(q2)
    assert torch.equal(tq.vgg16_features_q(q, imgs), tq.vgg16_features_q(q2, imgs))
    assert q2["qconvs"][0]["wq"].dtype == torch.int8
    assert all(torch.equal(a, b) and a.stride() == b.stride() for _, a, b in leaves(q, q2))
    bad = str(tmp_path / "bad.pt")
    tq.save_quantized(bad, {"convs": []})  # writes fine (any tree)
    with pytest.raises(ValueError, match="not a quantized"):
        tq.load_quantized(bad)


def test_obtain_quantized_shares_calibration(tmp_path):
    frozen = tpe.port_model_trunk("vgg16", vgg_tree(seed=3))
    p = str(tmp_path / "cal.pt")
    q1 = tq.obtain_quantized("vgg16", frozen, torch.from_numpy(images(seed=1)), path=p)
    q2 = tq.obtain_quantized("vgg16", frozen, torch.from_numpy(images(seed=9)), path=p)
    assert torch.equal(q1["qconvs"][0]["sx"], q2["qconvs"][0]["sx"])
    q3 = tq.quantize_vgg16(frozen, torch.from_numpy(images(seed=9)))
    assert float(q3["qconvs"][0]["sx"]) != float(q1["qconvs"][0]["sx"])


def test_inception_v3_quantized_features_close():
    t = _trunk("inception_v3")
    frozen, q = t["ttree"], t["tq"]
    imgs = torch.from_numpy(t["x"])
    assert tq.is_quantized(q) and not tq.is_quantized(frozen)
    qt = q["qinception"]
    assert "conv" in qt["Conv2d_1a_3x3"] and "wq" not in qt["Conv2d_1a_3x3"]  # the stem stays float
    assert qt["Conv2d_2a_3x3"]["wq"].dtype == torch.int8
    assert qt["Mixed_7c"]["branch_pool"]["wq"].dtype == torch.int8
    f = tenc.inception_v3_features(frozen, imgs)
    g = tq.inception_v3_features_q(q, imgs)
    assert f.shape == g.shape == (2, 2048)
    cos = tq.feature_agreement(frozen, q, imgs)
    assert cos > 0.97, cos
    imgs2 = torch.from_numpy(images(n=2, size=96, seed=3))
    assert torch.isfinite(tq.inception_v3_features_q(q, imgs2)).all()
    assert tq.feature_agreement(frozen, q, imgs2) > 0.96


def test_inception_v3_quantized_save_load_roundtrip(tmp_path):
    t = _trunk("inception_v3")
    imgs = torch.from_numpy(t["x"])
    p = str(tmp_path / "q_inc.pt")
    tq.save_quantized(p, t["tq"])
    q2 = tq.load_quantized(p)
    assert torch.equal(tq.inception_v3_features_q(t["tq"], imgs), tq.inception_v3_features_q(q2, imgs))
    with pytest.raises(ValueError, match="calibrated for inception_v3"):
        tq.obtain_quantized("vgg16", t["ttree"], imgs, path=p)
