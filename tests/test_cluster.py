"""k-means confidence tests, mirroring the reference's synthetic-cluster
fixture (generateParticleCluster, monte_carlo.cpp:1100-1150)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import ClusterConfig
from montecarlolocalisation.models import cluster

CFG = ClusterConfig()


def synthetic_cluster(key, n=1500, n_random=100,
                      center=(1.2, 4.4, -np.pi / 4)):
    """k uniform particles in [0, 4.4]^2 + a tight cluster (reference fixture)."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    xs = jax.random.uniform(k1, (n,), minval=0.0, maxval=4.4)
    ys = jax.random.uniform(k2, (n,), minval=0.0, maxval=4.4)
    ts = jax.random.uniform(k3, (n,), minval=-3.14, maxval=3.14)
    cx = center[0] + jax.random.uniform(k4, (n,), minval=-0.005, maxval=0.005)
    cy = center[1] + jax.random.uniform(k5, (n,), minval=-0.005, maxval=0.005)
    in_cluster = jnp.arange(n) >= n_random
    parts = jnp.stack([
        jnp.where(in_cluster, cx, xs),
        jnp.where(in_cluster, cy, ys),
        jnp.where(in_cluster, center[2], ts)], axis=-1)
    weights = jnp.full((n,), 1.0 / n)
    return parts, weights


def test_tight_cluster_found_and_confident():
    parts, weights = synthetic_cluster(jax.random.PRNGKey(0))
    ratio, pose = cluster.cluster_confidence(
        jax.random.PRNGKey(1), parts, weights, jnp.float32(0.5), CFG)
    # ~93% of particles within 0.4 m of the cluster center.
    assert float(ratio) > 0.8
    assert float(pose[0]) == pytest.approx(1.2, abs=0.15)
    assert float(pose[1]) == pytest.approx(4.4, abs=0.15)
    assert float(pose[2]) == pytest.approx(-np.pi / 4, abs=0.1)


def test_diffuse_particles_not_confident():
    key = jax.random.PRNGKey(2)
    parts, weights = synthetic_cluster(key, n=1500, n_random=1500)
    ratio, pose = cluster.cluster_confidence(
        jax.random.PRNGKey(3), parts, weights, jnp.float32(0.8), CFG)
    assert float(ratio) < 0.8
    np.testing.assert_array_equal(np.asarray(pose), [-1.0, -1.0, -1.0])


def test_best_cluster_by_weight_not_size():
    # Two spatial clusters; the smaller one carries all the weight.
    n = 200
    a = jnp.stack([jnp.full((150,), 0.5), jnp.full((150,), 0.5),
                   jnp.zeros((150,))], axis=-1)
    b = jnp.stack([jnp.full((50,), 3.5), jnp.full((50,), 3.5),
                   jnp.zeros((50,))], axis=-1)
    parts = jnp.concatenate([a, b])
    weights = jnp.concatenate([jnp.zeros((150,)), jnp.full((50,), 1.0)])
    # Seed chosen so the random init separates the two point masses (the
    # reference's random init has the same degenerate-init failure mode).
    ratio, pose = cluster.cluster_confidence(
        jax.random.PRNGKey(0), parts, weights, jnp.float32(0.1), CFG)
    assert float(pose[0]) == pytest.approx(3.5, abs=0.05)
    # Confidence counts ALL particles near the best center: 50/200.
    assert float(ratio) == pytest.approx(0.25, abs=0.02)


def test_kmeans_shapes_and_determinism():
    parts, _ = synthetic_cluster(jax.random.PRNGKey(5))
    c1, a1 = cluster.kmeans(jax.random.PRNGKey(6), parts[:, :2], CFG)
    c2, a2 = cluster.kmeans(jax.random.PRNGKey(6), parts[:, :2], CFG)
    assert c1.shape == (3, 2) and a1.shape == (1500,)
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))


# ---------------------------------------------------------------------------
# The dense Lloyd loop vs a NumPy transcription (monte_carlo.cpp:802-870).
# ---------------------------------------------------------------------------
def _lloyd_reference(xy, centers0, reseed):
    xy = np.asarray(xy, np.float32)
    centers = np.asarray(centers0, np.float32).copy()
    reseed = np.asarray(reseed, np.float32)
    k = centers.shape[0]
    assign = np.zeros(xy.shape[0], np.int64)
    done = False
    for it in range(reseed.shape[0]):
        d = ((xy[:, None, 0] - centers[None, :, 0]) ** 2
             + (xy[:, None, 1] - centers[None, :, 1]) ** 2)
        new = np.argmin(d, axis=1)          # ties -> lowest index
        changed = bool(np.any(new != assign))
        if changed and not done:
            means = np.empty_like(centers)
            for i in range(k):
                members = new == i
                means[i] = (xy[members].mean(axis=0) if members.any()
                            else reseed[it, i])   # empty -> reseed
            centers, assign = means, new
        done = done or not changed
    return centers, assign


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_kmeans_matches_numpy_lloyd(seed):
    key = jax.random.PRNGKey(seed)
    parts, _ = synthetic_cluster(key, n=2000, n_random=1200)
    xy = parts[:, :2]
    k0, k1 = jax.random.split(jax.random.fold_in(key, 1))
    centers0 = xy[jax.random.randint(k0, (CFG.k,), 0, xy.shape[0])]
    reseed = jax.random.uniform(k1, (CFG.max_iters, CFG.k, 2), maxval=4.4)
    c, a = cluster._kmeans_dense(xy, centers0, reseed, CFG)
    c_ref, a_ref = _lloyd_reference(xy, centers0, reseed)
    np.testing.assert_array_equal(np.asarray(a), a_ref)
    np.testing.assert_allclose(np.asarray(c), c_ref, rtol=1e-5, atol=1e-5)


def test_dense_kmeans_empty_cluster_reseeds():
    # A far-away initial center wins no particle: it must take the reseed
    # candidate of that iteration, exactly as the reference loop does.
    xy = jax.random.uniform(jax.random.PRNGKey(3), (300, 2), maxval=1.0)
    centers0 = jnp.array([[0.2, 0.2], [0.8, 0.8], [50.0, 50.0]])
    reseed = jnp.broadcast_to(jnp.array([[0.0, 0.0], [0.0, 0.0],
                                         [0.5, 0.1]]), (CFG.max_iters, 3, 2))
    c, a = cluster._kmeans_dense(xy, centers0, reseed, CFG)
    c_ref, a_ref = _lloyd_reference(xy, centers0, reseed)
    np.testing.assert_array_equal(np.asarray(a), a_ref)
    np.testing.assert_allclose(np.asarray(c), c_ref, rtol=1e-5, atol=1e-5)
    assert np.all(np.abs(np.asarray(c)) < 2.0)   # the far center moved in


def test_kmeans_under_vmap_matches_per_batch():
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    xys = jnp.stack([synthetic_cluster(k, n=600)[0][:, :2] for k in keys])
    ks = jax.random.split(jax.random.PRNGKey(6), 3)
    c_b, a_b = jax.vmap(lambda k, xy: cluster.kmeans(k, xy, CFG))(ks, xys)
    for e in range(3):
        c, a = cluster.kmeans(ks[e], xys[e], CFG)
        np.testing.assert_array_equal(np.asarray(a_b[e]), np.asarray(a))
        np.testing.assert_allclose(np.asarray(c_b[e]), np.asarray(c),
                                   rtol=1e-6, atol=1e-6)
