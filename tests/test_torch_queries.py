"""repro_torch.serving.queries' whole-Z read paths against the
reference's jitted ones: `gather_embeddings`, `class_centroids`,
`predict_labels` and `topk_cosine` on the same Z."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import topk_equivalent
from repro.serving import queries as JQ
from repro_torch.serving import queries as Q


@pytest.fixture(params=[8, 160])
def data(request, rng):
    K = request.param
    Z = rng.normal(size=(2000, K)).astype(np.float32)
    Z[::97] = 0.0                          # rows with no labelled donor
    Y = rng.integers(-1, K, 2000).astype(np.int32)
    nodes = rng.integers(0, 2000, 64).astype(np.int32)
    return Z, Y, nodes, K


def test_gather_embeddings(data):
    Z, _, nodes, _ = data
    assert np.array_equal(Q.gather_embeddings(torch.as_tensor(Z),
                                              nodes).numpy(),
                          np.asarray(JQ.gather_embeddings(jnp.asarray(Z),
                                                          nodes)))


def test_class_centroids_and_predict(data):
    Z, Y, nodes, K = data
    C = Q.class_centroids(torch.as_tensor(Z), Y, K=K)
    JC = JQ.class_centroids(jnp.asarray(Z), jnp.asarray(Y), K=K)
    np.testing.assert_allclose(C.numpy(), np.asarray(JC), atol=1e-5)
    pred, score = Q.predict_labels(torch.as_tensor(Z), C, nodes)
    jpred, jscore = JQ.predict_labels(jnp.asarray(Z), JC, jnp.asarray(nodes))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore),
                               atol=1e-5)
    sims = (Q.normalize_rows(torch.as_tensor(Z[nodes]))
            @ Q.normalize_rows(C).T)
    top2 = sims.topk(2, dim=1).values
    decided = ((top2[:, 0] - top2[:, 1]) > 1e-5).numpy()
    assert decided.sum() > 40
    assert np.array_equal(pred.numpy()[decided], np.asarray(jpred)[decided])


@pytest.mark.parametrize("k", [1, 10, 2500])
@pytest.mark.parametrize("pre_normalized", [False, True])
def test_topk_cosine(data, k, pre_normalized):
    Z, _, nodes, _ = data
    src = Q.normalize_rows(torch.as_tensor(Z)) if pre_normalized \
        else torch.as_tensor(Z)
    jsrc = JQ.normalize_rows(jnp.asarray(Z)) if pre_normalized \
        else jnp.asarray(Z)
    got = Q.topk_cosine(src, nodes, k=k, block_rows=512,
                        pre_normalized=pre_normalized)
    ref = JQ.topk_cosine(jsrc, nodes, k=k, block_rows=512,
                         pre_normalized=pre_normalized)
    topk_equivalent(*got, *ref)
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    if k > 2000:
        assert (got[0][:, 1999:] == -1).all()
