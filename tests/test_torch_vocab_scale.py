"""A 1,111,111-node ORBvoc (k=10, L=6: 10^6 words) as the port's live
vocabulary, against the JAX package: the generated tree, its DBoW2
binary file, the descent's word and node ids, the BoW vectors and the
keyframe database's candidates, then tests/test_vocab_scale_live.py's
drifted loop with that vocabulary, end to end.

The reference loads its ORBvoc at boot (src/System.cc:64-72) and every
keyframe's BoW is computed against it.  ``synthetic_orbvoc(k=10, L=6,
seed=7)`` has the real node count, layout and depth (the trained file
is not part of the repository).  The end-to-end run is the JAX test's:
tests/test_loop_proof.py's drifted circuit (radius 6, priors drifting
0.02 units a frame) over the planar ``make_world(seed=3)``, 640x480,
800 features, 4 levels, sequential mapping, each package with the
vocabulary loaded back from the binary file; the frames are rendered
once with the port's renderer and fed to both packages."""
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.io import orbvoc as jorbvoc
from orb_slam2_tpu_torch import interop
from orb_slam2_tpu_torch.geom.camera import Intrinsics
from orb_slam2_tpu_torch.io import orbvoc as torbvoc
from orb_slam2_tpu_torch.ops import extractor as tex
from orb_slam2_tpu_torch.pipeline.place_recognition import PlaceRecognition
from orb_slam2_tpu_torch.utils import synth

from test_torch_loop import check_circuit_parity, run_circuit
from test_torch_loop_height import circuit_config, drifted_poses

torch.set_num_threads(1)

K, L, SEED = 10, 6, 7
LOAD_S = 120.0       # the JAX test's bars: the file's load,
TRANSFORM_S = 2.0    # and a warm BoW transform of one keyframe


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    """Both packages' generated trees, each written by its own package,
    and each package's tree loaded back from the JAX package's file (the
    port's load timed)."""
    root = tmp_path_factory.mktemp("orbvoc")
    gen_j = jorbvoc.synthetic_orbvoc(k=K, L=L, seed=SEED)
    gen_t = torbvoc.synthetic_orbvoc(k=K, L=L, seed=SEED)
    path_j, path_t = str(root / "jax.bin"), str(root / "port.bin")
    jorbvoc.save_orbvoc_binary(gen_j, path_j)
    torbvoc.save_orbvoc_binary(gen_t, path_t)
    t0 = time.perf_counter()
    live = torbvoc.load_orbvoc_binary(path_t)
    load_s = time.perf_counter() - t0
    return dict(gen_j=gen_j, gen_t=gen_t, path_j=path_j, path_t=path_t,
                live_j=jorbvoc.load_orbvoc_binary(path_j), live=live,
                load_s=load_s)


def test_synthetic_orbvoc_equals_jax(vocab):
    """The generated tree: the same shape, every level's centers and the
    idf equal, bit for bit."""
    j, t = vocab["gen_j"], vocab["gen_t"]
    assert (t.k, t.levels, t.n_words) == (j.k, j.levels, K ** L)
    assert t.node_level == j.node_level
    assert len(t.centers) == len(j.centers) == L
    for cj, ct in zip(j.centers, t.centers):
        assert ct.dtype == cj.dtype and ct.shape == cj.shape
        np.testing.assert_array_equal(ct, cj)
    assert t.idf.dtype == j.idf.dtype
    np.testing.assert_array_equal(t.idf, j.idf)


def test_binary_file_is_the_jax_file_and_loads_back(vocab):
    """The port's DBoW2 binary file is byte for byte the JAX package's;
    loaded back by the port it is the JAX package's load of the same
    file (centers, idf, word ids, blocking level) and the generated
    tree; the load is within the JAX test's bar."""
    with open(vocab["path_j"], "rb") as a, open(vocab["path_t"], "rb") as b:
        assert a.read() == b.read()
    j, t = vocab["live_j"], vocab["live"]
    assert (t.k, t.levels, t.node_level) == (j.k, j.levels, j.node_level)
    assert t.n_words == K ** L
    for cj, ct, cg in zip(j.centers, t.centers, vocab["gen_t"].centers):
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_array_equal(ct, cg)
    np.testing.assert_array_equal(t.idf, j.idf)
    np.testing.assert_array_equal(t.word_of_slot, j.word_of_slot)
    assert vocab["load_s"] < LOAD_S, vocab["load_s"]


def _descriptors(n_features):
    """One rendered frame's descriptors (int32 bits) and valid rows: the
    circuit's 640x480 view with 800 features on 4 levels, or a 1920x1440
    view of bench.py's world with 4,000 features on 8 levels."""
    if n_features == 800:
        cam = Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                         width=640, height=480)
        world = synth.make_world(seed=3, device="cpu")
        T, n_levels = drifted_poses()[0][0], 4
    else:
        cam = Intrinsics(fx=960.0, fy=960.0, cx=960.0, cy=720.0,
                         width=1920, height=1440)
        world = synth.make_world(seed=7, tex_size=4096, scale=120.0,
                                 tex_shape=(3072, 4096), device="cpu")
        T, n_levels = synth.aerial_trajectory(1, height=12.0)[0], 8
    img = synth.render(world, cam, T).float()
    f = tex.extract(img, tex.OrbParams(n_features=n_features,
                                       n_levels=n_levels))
    assert int(f.valid.sum()) == n_features
    return f.desc, f.valid.numpy()


@pytest.mark.parametrize("n_features", [800, 4000])
def test_descent_and_bow_vector_bit_exact(vocab, n_features):
    """The live vocabulary's descent (6 levels, node ids at level 4) on
    one frame's descriptors: word and node ids equal to the JAX
    package's ``transform`` and to the host descent, and the BoW vector
    equal, bit for bit."""
    desc, valid = _descriptors(n_features)
    j, t = vocab["live_j"], vocab["live"]
    words, nodes = t.transform(desc)
    jw, jn = j.transform(jnp.asarray(desc.numpy().view(np.uint32)))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(
        words.numpy(), t.transform_np(desc.numpy().view(np.uint32)))
    assert len(np.unique(words.numpy()[valid])) > 0.5 * n_features
    bow = t.bow_vector_from_words(words.numpy()[valid])
    assert bow == j.bow_vector_from_words(np.asarray(jw)[valid])


@pytest.fixture(scope="module")
def circuit(vocab):
    true, fed = drifted_poses()
    cfg = circuit_config()
    world = synth.make_world(seed=3, device="cpu")
    images = [synth.render(world, cfg.cam, T).numpy() for T in true]
    return dict(run_circuit(cfg, images, fed, vocab=vocab["live"],
                            jvocab=vocab["live_j"]), true=true)


def test_loop_candidates_from_one_state(vocab, circuit):
    """The keyframe database at 10^6 words, from the JAX run's state at
    each loop query that returned keyframes before its first loop: the
    port's store built from the JAX store, each keyframe's BoW computed
    by the port's descent (equal to the JAX run's vectors), then the
    loop candidates (``loop_candidates``, the reference's
    DetectLoopCandidates) and the relocalization candidates of the
    query's BoW vector: the same keyframes in the same order."""
    recs = circuit["rec"]["candidates"]
    assert recs, "the JAX run found no loop candidates"
    for r in recs:
        store = interop.mapstore_from_numpy(**r["store"], device="cpu")
        pr = PlaceRecognition(store, vocab=vocab["live"])
        for kid in sorted(r["bow"]):
            pr.add_keyframe(kid)
            assert pr.bow[kid] == r["bow"][kid], kid
        assert set(pr.bow) == set(r["bow"])
        assert pr.loop_candidates(r["kid"], r["min_score"]) == r["out"]
        assert (pr.reloc_candidates(pr.bow[r["kid"]])
                == r["reloc"]), r["kid"]


def test_million_word_circuit_as_the_jax_run(vocab, circuit):
    """Bars: the JAX test's on both runs (>= 1 loop closed with the
    10^6-word vocabulary doing candidate retrieval, > 0.7 of the frames
    OK, a finite map; the port's load under 120 s and a warm transform
    of the last keyframe's descriptors under 2 s) and the port held to
    the JAX run (``check_circuit_parity``)."""
    jsys, port, true = circuit["jsys"], circuit["port"], circuit["true"]
    assert port.place_rec.vocab is vocab["live"]
    assert jsys.loop_closer.pr.vocab is vocab["live_j"]
    for s in (jsys, port):
        ok = sum(st.name == "OK" for (_, _, _, st) in s.trajectory)
        assert ok > 0.7 * len(true), ok
        assert s.loop_closer.n_loops_closed >= 1
        assert np.isfinite(s.map_points()).all()
    check_circuit_parity(circuit, true)
    desc = port.store.kfs[-1].frame.dev("desc")
    vocab["live"].transform(desc)
    t0 = time.perf_counter()
    words, _ = vocab["live"].transform(desc)
    words.numpy()
    assert time.perf_counter() - t0 < TRANSFORM_S
