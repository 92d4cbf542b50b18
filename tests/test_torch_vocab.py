"""The port's vocabulary and keyframe database against the JAX package's,
on the same seeded descriptors: training, word ids and common-word counts
exact; BoW vectors, database weights and scores within 1e-6; the candidate
masks of the Detect* queries equal. Descriptor words cross as int32 holding
the uint32 bits."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)   # several test workers share few cores

from multiagent_orb_slam2_tpu.vocab import bow as jbow
from multiagent_orb_slam2_tpu.vocab import kfdb as jkfdb
from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.vocab import bow as tbow
from multiagent_orb_slam2_tpu_torch.vocab import kfdb as tkfdb

from test_vocab import perturb, random_descs


def _t(a):
    return convert.to_tensor(np.asarray(a), "cpu")


def _ones(n):
    return jnp.ones(n, bool), torch.ones(n, dtype=torch.bool)


@pytest.fixture(scope="module")
def vocabs():
    """One training corpus, trained by both packages (k=6, depth=3)."""
    corpus = random_descs(np.random.default_rng(5), 4000)
    return (jbow.train_vocabulary(corpus, k=6, depth=3, seed=6),
            tbow.train_vocabulary(corpus, k=6, depth=3, seed=6,
                                  device="cpu"))


def _db_equal(jdb, tdb):
    got = convert.kfdb_to_numpy(tdb)
    np.testing.assert_array_equal(got["words"], np.asarray(jdb.words))
    np.testing.assert_array_equal(got["active"], np.asarray(jdb.active))
    np.testing.assert_allclose(got["wts"], np.asarray(jdb.wts), atol=1e-6)


def test_training_and_transform_match_jax(vocabs):
    jv, tv = vocabs
    got = convert.vocabulary_to_numpy(tv)
    for a, b in zip(jv.centroids, got["centroids"]):
        np.testing.assert_array_equal(b, np.asarray(a))
    np.testing.assert_allclose(got["idf"], np.asarray(jv.idf), atol=1e-6)
    assert (tv.k, tv.depth, tv.n_words) == (jv.k, jv.depth, jv.n_words)
    rng = np.random.default_rng(7)
    d = random_descs(rng, 300)
    jvalid = jnp.asarray(rng.random(300) < 0.9)
    tvalid = _t(jvalid)
    jw = jbow.transform_words(jv, jnp.asarray(d), jvalid)
    tw = tbow.transform_words(tv, _t(d), tvalid)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(
        tbow.bow_vector(tv, tw, tvalid).numpy(),
        np.asarray(jbow.bow_vector(jv, jw, jvalid)), atol=1e-6)


def test_scores_and_common_words_match_jax(vocabs):
    jv, tv = vocabs
    rng = np.random.default_rng(8)
    frames = [random_descs(rng, 150) for _ in range(5)]
    frames[3] = perturb(rng, frames[0], 8)
    jo, to = _ones(150)
    jw = [jbow.transform_words(jv, jnp.asarray(f), jo) for f in frames]
    jvec = jnp.stack([jbow.bow_vector(jv, w, jo) for w in jw])
    tw = [tbow.transform_words(tv, _t(f), to) for f in frames]
    tvec = torch.stack([tbow.bow_vector(tv, w, to) for w in tw])
    np.testing.assert_allclose(tbow.l1_score(tvec[0], tvec).numpy(),
                               np.asarray(jbow.l1_score(jvec[0], jvec)),
                               atol=1e-6)
    pres = np.asarray(jvec > 0)
    np.testing.assert_array_equal(
        tbow.common_words(tw[0], to, _t(pres)).numpy(),
        np.asarray(jbow.common_words(jw[0], jo, jnp.asarray(pres))))


@pytest.mark.parametrize("max_words", [1024, 48])
def test_database_matches_jax(vocabs, max_words):
    """Registration, erasure, scores and common words; in a table 48 words
    wide a keyframe keeps its 48 lowest word ids, as in the JAX package (the
    loop closer and the server make the table as wide as the feature
    capacity, and so keep every word)."""
    jv, tv = vocabs
    rng = np.random.default_rng(9)
    K = 12
    jdb = jkfdb.empty_database(K, jv, max_words_per_kf=max_words)
    tdb = tkfdb.empty_database(K, tv, max_words_per_kf=max_words)
    frames = [random_descs(rng, 120) for _ in range(8)]
    jo, to = _ones(120)
    for i, f in enumerate(frames):
        jdb, jw, jvec = jkfdb.add_keyframe(jdb, jv, i, jnp.asarray(f), jo)
        tdb, tw, tvec = tkfdb.add_keyframe(tdb, tv, i, _t(f), to)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_allclose(tvec.numpy(), np.asarray(jvec), atol=1e-6)
    _db_equal(jdb, tdb)
    carried = convert.kfdb_from_numpy(
        {k: np.asarray(v) for k, v in jdb._asdict().items()}, "cpu")
    _db_equal(jdb, carried)
    if max_words == 48:
        assert int((tdb.words >= 0).sum(1).max()) == 48
    jdb, tdb = jkfdb.erase_keyframe(jdb, 3), tkfdb.erase_keyframe(tdb, 3)
    _db_equal(jdb, tdb)
    q = perturb(rng, frames[2], 4)
    jw = jbow.transform_words(jv, jnp.asarray(q), jo)
    jvec = jbow.bow_vector(jv, jw, jo)
    tw, tvec = _t(jw), _t(jvec)
    js, jc = jkfdb.score_and_common(jdb, jw, jo, jvec)
    ts, tc = tkfdb.score_and_common(tdb, tw, to, tvec)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    rows = np.array([0, 2, 5])
    np.testing.assert_allclose(
        tkfdb.score_kfs(tdb, tvec, _t(rows)).numpy(),
        np.asarray(jkfdb.score_kfs(jdb, jvec, jnp.asarray(rows))), atol=1e-6)


def test_database_keeps_every_word_at_2048_features():
    """Fault 3 (ROADMAP.md queue 3), the port's departure from the JAX
    package: at F = 2048 a keyframe has more than 1024 unique words. The
    port's table, as wide as the feature capacity, keeps them all, as the
    reference's KeyFrameDatabase::add does: it equals the JAX database made
    with max_words_per_kf=2048, and scores agree at 1e-6. The JAX default
    keeps the 1024 lowest ids, and the words past rank 1024 are absent from
    its row. convert.kfdb_from_numpy widens such a [K, 1024] table with
    padding, and narrows a table only where it cuts padding alone."""
    rng = np.random.default_rng(12)
    k, depth, F, K = 16, 3, 2048, 4
    cents = [rng.integers(0, 2**32, (k ** (lv + 1), 8), dtype=np.uint32)
             for lv in range(depth)]
    idf = rng.uniform(0.5, 3.0, k ** depth).astype(np.float32)
    jv = jbow.Vocabulary([jnp.asarray(c) for c in cents], jnp.asarray(idf),
                         k, depth)
    tv = convert.vocabulary_from_numpy(
        {"centroids": cents, "idf": idf, "k": k, "depth": depth}, "cpu")
    jwide = jkfdb.empty_database(K, jv, max_words_per_kf=F)
    jcap = jkfdb.empty_database(K, jv)
    tdb = tkfdb.empty_database(K, tv, F)
    frames = [random_descs(rng, F) for _ in range(3)]
    valid = [rng.random(F) < 0.95 for _ in frames]
    frames.append(random_descs(rng, F))
    valid.append(np.arange(F) < 200)
    n_unique = []
    for i, (f, v) in enumerate(zip(frames, valid)):
        jwide, jw, _ = jkfdb.add_keyframe(jwide, jv, i, jnp.asarray(f),
                                          jnp.asarray(v))
        jcap, _, _ = jkfdb.add_keyframe(jcap, jv, i, jnp.asarray(f),
                                        jnp.asarray(v))
        tdb, tw, _ = tkfdb.add_keyframe(tdb, tv, i, _t(f), _t(v))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        n_unique.append(len(np.unique(tw.numpy()[v])))
    assert min(n_unique[:3]) > 1024 and n_unique[3] <= 200
    _db_equal(jwide, tdb)
    rows, cap = tdb.words.numpy(), np.asarray(jcap.words)
    np.testing.assert_array_equal((rows >= 0).sum(1), n_unique)  # no drop
    for i in range(3):
        kept = rows[i][:n_unique[i]]
        np.testing.assert_array_equal(cap[i], kept[:1024])
        assert not np.isin(kept[1024:], cap[i]).any()
    q = perturb(rng, frames[1], 6)
    jo, to = _ones(F)
    jw = jbow.transform_words(jv, jnp.asarray(q), jo)
    jvec = jbow.bow_vector(jv, jw, jo)
    js, jc = jkfdb.score_and_common(jwide, jw, jo, jvec)
    ts, tc = tkfdb.score_and_common(tdb, _t(jw), to, _t(jvec))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    cs, _ = jkfdb.score_and_common(jcap, jw, jo, jvec)
    assert float(cs[1]) < float(ts[1]) - 0.05       # what the cap cost
    # across the packages: a JAX [K, 1024] table brought to the port's width
    fields = {f: np.asarray(a) for f, a in jcap._asdict().items()}
    wide = convert.kfdb_from_numpy(fields, "cpu", width=F)
    assert wide.words.shape == (K, F)
    _db_equal(jcap, convert.kfdb_from_numpy(
        convert.kfdb_to_numpy(wide), "cpu", width=1024))
    np.testing.assert_allclose(
        tkfdb.score_and_common(wide, _t(jw), to, _t(jvec))[0].numpy(),
        np.asarray(cs), atol=1e-6)
    with pytest.raises(AssertionError):
        convert.kfdb_from_numpy(fields, "cpu", width=512)
    small = {f: a[3:] for f, a in fields.items()}
    narrow = convert.kfdb_from_numpy(small, "cpu", width=256)
    np.testing.assert_array_equal(narrow.words.numpy(),
                                  small["words"][:, :256])


def _query_setup(vocabs, seed):
    """A 10-keyframe database where keyframes 7 and 8 revisit keyframe 2, a
    noisy query of keyframe 2, and a covisibility matrix with tied
    weights."""
    jv, tv = vocabs
    rng = np.random.default_rng(seed)
    K = 16
    jdb, tdb = jkfdb.empty_database(K, jv), tkfdb.empty_database(K, tv, 1024)
    frames = [random_descs(rng, 120) for _ in range(10)]
    frames[7] = perturb(rng, frames[2], 6)
    frames[8] = perturb(rng, frames[2], 9)
    jo, to = _ones(120)
    for i, f in enumerate(frames):
        jdb, _, _ = jkfdb.add_keyframe(jdb, jv, i, jnp.asarray(f), jo)
        tdb, _, _ = tkfdb.add_keyframe(tdb, tv, i, _t(f), to)
    covis = np.zeros((K, K), np.int32)
    for a, b, w in ((2, 1, 50), (2, 3, 40), (7, 8, 30), (7, 9, 30),
                    (8, 9, 30), (7, 6, 30)):
        covis[a, b] = covis[b, a] = w
    q = perturb(rng, frames[2], 4)
    jw = jbow.transform_words(jv, jnp.asarray(q), jo)
    jvec = jbow.bow_vector(jv, jw, jo)
    return (jdb, jw, jo, jvec, jnp.asarray(covis)), \
        (tdb, _t(jw), to, _t(jvec), _t(covis))


@pytest.mark.parametrize("query", ["loop", "reloc", "covisibility"])
def test_detect_candidates_match_jax(vocabs, query):
    """Candidate masks of the three Detect* queries equal; the group
    accumulation meets covisibility weights that tie (top-k order)."""
    jv, tv = vocabs
    (jdb, jw, jo, jvec, jcov), (tdb, tw, to, tvec, tcov) = \
        _query_setup(vocabs, 10)
    if query == "loop":
        jc, js = jkfdb.detect_loop_candidates(jdb, jv, jw, jo, jvec, jcov[2],
                                              2, jcov, min_score=0.015)
        tc, ts = tkfdb.detect_loop_candidates(tdb, tv, tw, to, tvec, tcov[2],
                                              2, tcov, min_score=0.015)
        # the revisit group {7, 8} is returned through its best member
        assert (tc[7] or tc[8]) and not (tc[1] or tc[2] or tc[3])
    elif query == "reloc":
        jc, js = jkfdb.detect_reloc_candidates(jdb, jw, jo, jvec, jcov)
        tc, ts = tkfdb.detect_reloc_candidates(tdb, tw, to, tvec, tcov)
        assert bool(tc[[2, 7, 8]].any())        # the place, no exclusion
    else:
        ignore = np.zeros(16, bool)
        ignore[[1, 2]] = True
        jc, js = jkfdb.detect_covisibility_candidates(
            jdb, jw, jo, jvec, jnp.asarray(ignore), jcov)
        tc, ts = tkfdb.detect_covisibility_candidates(
            tdb, tw, to, tvec, _t(ignore), tcov)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


def test_grouped_candidates_ties_match_jax():
    """Every candidate with the same covisibility weight to several others
    and equal scores: the group members and best members come out in index
    order, as jax.lax.top_k orders ties."""
    from multiagent_orb_slam2_tpu.vocab.kfdb import _grouped_candidates as jg
    rng = np.random.default_rng(11)
    K = 24
    for trial in range(5):
        covis = rng.integers(0, 3, (K, K)).astype(np.int32) * 20
        covis = np.triu(covis, 1) + np.triu(covis, 1).T
        scores = rng.choice([0.1, 0.2, 0.3], K).astype(np.float32)
        cand = rng.random(K) < 0.6
        want = jg(jnp.asarray(scores), jnp.asarray(cand), jnp.asarray(covis))
        got = tkfdb._grouped_candidates(_t(scores), _t(cand), _t(covis))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_save_load_across_packages(vocabs, tmp_path):
    jv, tv = vocabs
    tbow.save_vocabulary(tv, tmp_path / "t.npz")
    jbow.save_vocabulary(jv, str(tmp_path / "j.npz"))
    j_from_t = jbow.load_vocabulary(str(tmp_path / "t.npz"))
    t_from_j = tbow.load_vocabulary(tmp_path / "j.npz", device="cpu")
    carried = convert.vocabulary_from_numpy(
        {"centroids": [np.asarray(c) for c in jv.centroids],
         "idf": np.asarray(jv.idf), "k": jv.k, "depth": jv.depth}, "cpu")
    d = random_descs(np.random.default_rng(12), 64)
    jo, to = _ones(64)
    want = np.asarray(jbow.transform_words(jv, jnp.asarray(d), jo))
    np.testing.assert_array_equal(
        np.asarray(jbow.transform_words(j_from_t, jnp.asarray(d), jo)), want)
    for v in (t_from_j, carried):
        np.testing.assert_array_equal(
            tbow.transform_words(v, _t(d), to).numpy(), want)


def test_committed_vocabulary_and_missing_file():
    """The default path is the committed 100k-word asset, read as the JAX
    package reads it; a missing file raises (nothing is trained in its
    place)."""
    tv = tbow.load_vocabulary(device="cpu")
    jv = jbow.load_vocabulary(str(tbow.DEFAULT_VOCAB))
    assert (tv.k, tv.depth, tv.n_words) == (10, 5, 100000)
    np.testing.assert_array_equal(tv.idf.numpy(), np.asarray(jv.idf))
    d = random_descs(np.random.default_rng(13), 200)
    jo, to = _ones(200)
    np.testing.assert_array_equal(
        tbow.transform_words(tv, _t(d), to).numpy(),
        np.asarray(jbow.transform_words(jv, jnp.asarray(d), jo)))
    with pytest.raises(FileNotFoundError, match="vocabulary"):
        tbow.load_vocabulary(tbow.DEFAULT_VOCAB.with_name("missing.npz"),
                             device="cpu")
