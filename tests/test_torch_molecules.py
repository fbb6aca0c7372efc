"""The port's molecule slice against the JAX package, on the CPU.

The chemistry helpers and the SMILES converter bit for bit on seeded
generators; the synthetic dataset bit for bit and a dataset file placed in
``data_dir``; ``EdgeGNN`` in both degree norms and both dtypes; a tiny
``GraphCNF`` (graphs of 6 nodes, hidden 16, node latents of dim 2, K = 3)
with its levers off (2 node layers, 1 edge layer a stage: unrolled stacks)
and all on (1 node and 1 existence layer, 4 bond layers: a scanned stack
with remat) on the same seeded weights, carried across by
``convert.from_jax_params``: the loss and the IS bits/var with shared
noise, the gradients (levers on), a sample with shared prior noise;
the masked-density integrity of the edge stages on the port; then
``MoleculeTask`` for a few steps, the ``/sample`` payload and the CLI round
trip through ``load_run`` and ``sample_eval``.

Tolerances: ``TOL`` = 1e-4 for fp32 values, as the graph-coloring slice's
test; the gradients within ``GRAD_REL`` = 1e-3 of their norm; bf16 nets
within 2 bf16 ulps at the output's scale, as the RGCN's test.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from categoricalnf_tpu.data import smiles as jsmiles
from categoricalnf_tpu.models.graphcnf import GraphCNF as JaxGraphCNF
from categoricalnf_tpu.networks.graph import EdgeGNN as JaxEdgeGNN
from categoricalnf_tpu.tasks import chem as jchem
from categoricalnf_tpu.tasks import molecules as jmol
from categoricalnf_tpu_torch import convert
from categoricalnf_tpu_torch import flows as tflows
from categoricalnf_tpu_torch.data import smiles as tsmiles
from categoricalnf_tpu_torch.models.graphcnf import GraphCNF
from categoricalnf_tpu_torch.networks import EdgeGNN
from categoricalnf_tpu_torch.networks.graph import (incidence_matrix,
                                                    pair_indices)
from categoricalnf_tpu_torch.tasks import chem as tchem
from categoricalnf_tpu_torch.tasks import molecules as tmol

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

TOL = 1e-4
GRAD_REL = 1e-3
N, E, B = 6, 15, 3
SMALL = dict(num_atom_types=4, num_bond_types=3, max_nodes=N, node_dim=2,
             exist_dim=2, bond_dim=2, hidden_dim=16, num_mixtures=3)
LEVERS = {
    "off": dict(num_layers_node=2, num_layers_edge=1),
    "on": dict(num_layers_node=1, num_layers_edge=1, num_layers_bond=4,
               edge_degree_norm="live_edges", bond_cond_exist=True,
               node_cond_atoms=True, bond_cond_degree=True)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape, jnp.float32,
                                         minval=1e-6, maxval=1.0 - 1e-6))


# -- chem and smiles, bit for bit ---------------------------------------------


def _molecules(seed, n=12):
    r = np.random.default_rng(seed)
    return [tchem.random_molecule(r, int(r.integers(2, 12)))
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_generators_match_reference_bit_for_bit(seed):
    for gen in ("random_molecule", "zinc_like_molecule"):
        for kw in ([{}, {"leaf_style": "moses"}]
                   if gen == "zinc_like_molecule" else [{}]):
            r1, r2 = (np.random.default_rng(seed) for _ in range(2))
            for n in (3, 9, 17):
                a1, adj1 = getattr(jchem, gen)(r1, n, **kw)
                a2, adj2 = getattr(tchem, gen)(r2, n, **kw)
                np.testing.assert_array_equal(a1, a2)
                np.testing.assert_array_equal(adj1, adj2)
                assert a1.dtype == a2.dtype and adj1.dtype == adj2.dtype
    assert tchem.ATOM_TYPES == jchem.ATOM_TYPES
    assert tchem.MAX_VALENCE == jchem.MAX_VALENCE


def test_validity_correction_hashes_and_quality_match_reference():
    r = np.random.default_rng(3)
    n = 10
    atoms = r.integers(0, 9, (16, n)).astype(np.int32)
    edges = (r.integers(0, 4, (16, n * (n - 1) // 2))
             * (r.random((16, n * (n - 1) // 2)) < 0.25)).astype(np.int32)
    mask = (np.arange(n)[None] < r.integers(1, n + 1, (16, 1))).astype(
        np.float32)
    for c in (True, False):
        np.testing.assert_array_equal(
            tchem.molecule_validity(atoms, edges, mask, check_connected=c),
            jchem.molecule_validity(atoms, edges, mask, check_connected=c))
    for got, want in zip(tchem.valency_correction(atoms, edges, mask),
                         jchem.valency_correction(atoms, edges, mask)):
        np.testing.assert_array_equal(got, want)
    d = np.stack([tchem.edges_to_dense(e, n) for e in edges])
    np.testing.assert_array_equal(d, np.stack(
        [jchem.edges_to_dense(e, n) for e in edges]))
    np.testing.assert_array_equal(tchem.dense_to_edges(d[0]), edges[0])
    hashes = {tchem.wl_hash(atoms[b], edges[b], mask[b]) for b in range(8)}
    assert hashes == {jchem.wl_hash(atoms[b], edges[b], mask[b])
                      for b in range(8)}
    for correct in (False, True):
        for c in (False, True):
            assert tchem.sample_quality(atoms, edges, mask, hashes, correct,
                                        c) == jchem.sample_quality(
                atoms, edges, mask, hashes, correct, c)


SMILES = ["CCO", "c1ccccc1", "C1=CC=CC=C1O", "CC(=O)Nc1ccc(O)cc1",
          "c1ccc2[nH]ccc2c1", "C[N+](C)(C)C", "O=C([O-])c1ccccc1",
          "C#N", "ClC(Br)I", "C%10CCCCC%10", "F/C=C/F", "C[C@@H](N)O",
          "CC.O", "[Si]C", "c1cccc1", "C1CC", "C(C"]


def test_smiles_match_reference():
    for s in SMILES:
        got, want = tsmiles.smiles_to_graph(s), jsmiles.smiles_to_graph(s)
        assert (got is None) == (want is None), s
        if got is not None:
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        try:
            want = jsmiles.parse_smiles(s)
        except jsmiles.SmilesError:
            with pytest.raises(tsmiles.SmilesError):
                tsmiles.parse_smiles(s)
            continue
        got = tsmiles.parse_smiles(s)
        assert [vars(a) for a in got[0]] == [vars(a) for a in want[0]]
        assert got[1] == want[1]
    for a, adj in _molecules(4):
        s = tsmiles.graph_to_smiles(a, adj)
        assert s == jsmiles.graph_to_smiles(a, adj)
        back = tsmiles.smiles_to_graph(s)
        assert back is not None and len(back[0]) == len(a)


def test_synthetic_dataset_and_npz_match_reference(tmp_path):
    got = tmol.load_molecule_dataset("synthetic", None, 9, 16, seed=2)
    want = jmol.load_molecule_dataset("synthetic", None, 9, 16, seed=2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    with pytest.raises(FileNotFoundError, match="zinc250k"):
        tmol.load_molecule_dataset("zinc250k", str(tmp_path), 9)
    _write_npz(tmp_path, "tiny")
    got = tmol.load_molecule_dataset("tiny", str(tmp_path), N)
    want = jmol.load_molecule_dataset("tiny", str(tmp_path), N)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _write_npz(tmp_path, name, count=40, seed=0):
    """A preprocessed dataset of ``count`` random valid molecules of 3-6
    atoms, as ``preprocess.py`` writes one."""
    r = np.random.default_rng(seed)
    atoms = np.zeros((count, N), np.int8)
    edges = np.zeros((count, E), np.int8)
    num = r.integers(3, N + 1, count)
    for m in range(count):
        a, adj = tchem.random_molecule(r, int(num[m]))
        atoms[m, :num[m]] = np.minimum(a, 3)
        full = np.zeros((N, N), np.int64)
        full[:num[m], :num[m]] = adj
        edges[m] = tchem.dense_to_edges(full)
    np.savez(tmp_path / f"{name}.npz", atoms=atoms, edges=edges,
             num_atoms=num)


# -- EdgeGNN ------------------------------------------------------------------


def _jax_params(model, seed, *args):
    """Seeded random weights of the reference's tree, shaped by tracing its
    ``init(key, *args)`` (no init is run): the 1x1 layers' permutations the
    identity and their signs 1, every other leaf N(0, 0.25^2), so that no
    coupling is the identity."""
    r = np.random.default_rng(seed)

    def leaf(path, shape):
        name, shp = getattr(path[-1], "key", ""), shape.shape
        if name in ("perm", "lower"):
            eye = np.broadcast_to(np.eye(shp[-1], dtype=np.float32), shp)
        if name == "perm":
            return eye.copy()
        if name == "sign_s":
            return np.ones(shp, np.float32)
        v = 0.25 * r.standard_normal(shp)
        if name == "lower":
            return (eye + np.tril(v, -1)).astype(np.float32)
        if name == "upper":
            return np.triu(v, 1).astype(np.float32)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(lambda k: model.init(k, *args),
                             jax.random.PRNGKey(0)))


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["nodes", "live_edges"])
def test_edge_gnn_matches_reference(norm, cd):
    """Masked EdgeGNN with edge features on the reference's weights (random
    output layer): fp32 within 1e-5; bf16 within 2 bf16 ulps at the
    output's scale (another sum order and gelu rounding can flip a
    rounding of the bf16 stream)."""
    r = np.random.default_rng(len(norm))
    j = JaxEdgeGNN(num_nodes=N, hidden_dim=16, num_layers=2,
                   edge_feat_dim=2, degree_norm=norm, compute_dtype=cd)
    params = _jax_params(j, len(norm), 3, 20, 5)
    net = EdgeGNN(3, 20, 5, num_nodes=N, hidden_dim=16, num_layers=2,
                  edge_feat_dim=2, degree_norm=norm, compute_dtype=cd)
    net.load_state_dict(convert.flatten_tree(params))
    x = r.standard_normal((B, E, 3)).astype(np.float32)
    node_mask = (np.arange(N)[None] < np.array([[6], [4], [2]])).astype(
        np.float32)
    cond = {"node_feat": r.standard_normal((B, N, 5)).astype(np.float32),
            "node_mask": node_mask,
            "edge_feat": r.standard_normal((B, E, 2)).astype(np.float32)}
    mask = (r.random((B, E)) < 0.7).astype(np.float32)
    want = np.asarray(j.apply(params, jnp.asarray(x),
                              cond=jax.tree.map(jnp.asarray, cond),
                              mask=jnp.asarray(mask))).astype(np.float32)
    with torch.no_grad():
        got = net(torch.tensor(x), cond=jax.tree.map(torch.tensor, cond),
                  mask=torch.tensor(mask))
    assert got.dtype == getattr(torch, cd)
    tol = 1e-5 if cd == "float32" else 2.0 ** -6 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_pairs_and_incidence():
    ii, jj = pair_indices(N)
    assert ii.tolist() == np.triu_indices(N, 1)[0].tolist()
    inc = incidence_matrix(N)
    assert inc.shape == (E, N) and (inc.sum(1) == 2).all()
    assert inc[torch.arange(E), ii].eq(1).all()
    assert inc[torch.arange(E), jj].eq(1).all()


# -- GraphCNF against the reference -------------------------------------------


class _Holder:
    def __init__(self, model):
        self.model = model


_PAIRS: dict = {}


def _pair(levers):
    """The reference's GraphCNF and the port's on the same weights, and a
    batch of graphs of 6, 4 and 3 nodes."""
    if levers not in _PAIRS:
        kw = {**SMALL, **LEVERS[levers]}
        j = JaxGraphCNF(**kw)
        params = _jax_params(j, 1)
        t = GraphCNF(**kw)
        t.load_state_dict(convert.from_jax_params(_Holder(t), params))
        r = np.random.default_rng(2)
        node_mask = (np.arange(N)[None] < np.array([[6], [4], [3]])).astype(
            np.float32)
        atoms = (r.integers(0, 4, (B, N)) * node_mask).astype(np.int32)
        e_mask = np.asarray(j.edge_mask(jnp.asarray(node_mask)))
        edges = (r.integers(0, 4, (B, E)) * e_mask).astype(np.int32)
        _PAIRS[levers] = (j, params, t, atoms, edges, node_mask)
    return _PAIRS[levers]


def _stage_noise(key, lead=()):
    shapes = [(B, N, 2), (B, E, 2), (B, E, 2)]
    return [_uniform(k, lead + s) for k, s in
            zip(jax.random.split(key, 3), shapes)]


@pytest.mark.parametrize("levers", ["off", "on"])
def test_graphcnf_matches_reference(levers):
    """With the encoders' uniforms shared: loss_bpd (beta 0.8) and eval_bpd
    of 4 chains within TOL; with the levers on (every lever, a scanned
    bond stack), every gradient within GRAD_REL of the whole gradient's
    norm.  A sample with the stages' prior uniforms shared at per-stage
    temperatures: the atoms and edges equal, none on a padded pair."""
    j, params, t, atoms, edges, node_mask = _pair(levers)
    if levers == "on":
        (scan,) = t.flow_bond.layers
        assert isinstance(scan, tflows.ScannedBlocks) and scan.remat
    key, skey = jax.random.PRNGKey(3), jax.random.PRNGKey(7)
    S, temps = 4, (0.9, 1.0, 0.8)
    jargs = (jnp.asarray(atoms), jnp.asarray(edges), jnp.asarray(node_mask))
    targs = (torch.tensor(atoms), torch.tensor(edges),
             torch.tensor(node_mask))

    @jax.jit
    def reference(p):
        def loss(q):
            return j.loss_bpd(q, *jargs, key, 0.8)
        lg = (jax.value_and_grad(loss)(p) if levers == "on"
              else (loss(p), None))
        return (lg, j.eval_bpd(p, *jargs, key, S),
                j.sample(p, skey, jargs[2], temperature=jnp.asarray(temps)))

    (jl, jg), jbpd, (ja, je) = _np(reference(
        jax.tree.map(jnp.asarray, params)))

    t.zero_grad()
    tl = t.loss_bpd(*targs, 0.8, noise=tuple(
        torch.tensor(u) for u in _stage_noise(key)))
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=TOL, atol=TOL)
    if levers == "on":
        tl.backward()
        want = convert.from_jax_params(_Holder(t), jg)
        got = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
               for k, p in t.named_parameters()}
        norm = float(torch.sqrt(sum((want[k] ** 2).sum() for k in got)))
        diff = float(torch.sqrt(sum(((got[k] - want[k]) ** 2).sum()
                                    for k in got)))
        assert diff <= GRAD_REL * norm, (diff, norm)

    keys = jax.random.split(key, S)
    noise = [np.stack(u) for u in zip(*(_stage_noise(k) for k in keys))]
    with torch.no_grad():
        tbpd = t.eval_bpd(*targs, S, noise=tuple(map(torch.tensor, noise)))
        ta, te = t.sample(torch.tensor(node_mask), temps,
                          noise=tuple(map(torch.tensor, _stage_noise(skey))))
    np.testing.assert_allclose(tbpd.numpy(), jbpd, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ta.numpy(), ja)
    np.testing.assert_array_equal(te.numpy(), je)
    e_mask = np.asarray(j.edge_mask(jnp.asarray(node_mask)))
    assert (te.numpy()[e_mask == 0] == 0).all()


def test_sample_stages_take_given_earlier_stages():
    """``sample_stages`` is ``sample`` before its assembly; given its own
    stages it returns them again, and given another draw's, each stage
    keeps its own prior draw and takes the later conditions from them."""
    _, _, t, _, _, node_mask = _pair("on")
    mask = torch.tensor(node_mask)
    own, other = (tuple(map(torch.tensor, _stage_noise(jax.random.PRNGKey(k))))
                  for k in (7, 8))
    with torch.no_grad():
        st = t.sample_stages(mask, noise=own)
        atoms, edges = t.sample(mask, noise=own)
        again = t.sample_stages(mask, noise=own, given=st)
        alt = t.sample_stages(mask, noise=other)
        mixed = t.sample_stages(mask, noise=own, given=alt)
    np.testing.assert_array_equal(atoms.numpy(), (st["atoms"] * mask).numpy())
    np.testing.assert_array_equal(edges.numpy(), (
        st["exist"] * (1 + st["bond"]) * t.edge_mask(mask)).numpy())
    for k in st:
        assert torch.equal(again[k], st[k]), k
    assert torch.equal(mixed["z_v"], st["z_v"])
    assert not torch.equal(mixed["z_e1"], st["z_e1"])


def _valid_submap_logdet(flow, z, cond, mask):
    """The port's version of ``tests/test_mask_integrity.py``'s check:
    valid outputs do not depend on masked inputs, and the claimed ldj is
    the log-determinant of the valid sub-Jacobian."""
    D = z.shape[-1]
    vmask = np.repeat(mask.numpy().reshape(-1), D).astype(bool)

    def f(flat):
        out, _ = flow(flat.reshape(z.shape), cond=cond, mask=mask)
        return out.reshape(-1)

    J = torch.autograd.functional.jacobian(f, z.reshape(-1)).double().numpy()
    vidx, midx = np.nonzero(vmask)[0], np.nonzero(~vmask)[0]
    leak = np.abs(J[np.ix_(vidx, midx)]).max() if len(midx) else 0.0
    _, true_ld = np.linalg.slogdet(J[np.ix_(vidx, vidx)])
    with torch.no_grad():
        _, ldj = flow(z, cond=cond, mask=mask)
    assert leak < 1e-6, f"masked -> valid leakage {leak}"
    np.testing.assert_allclose(float(ldj[0]), true_ld, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("stage", ["exist", "bond"])
def test_edge_stages_keep_masked_density_integrity(stage):
    """The bond stage under a sparse bond mask (levers on) and the
    existence stage under the pair mask of 4 live nodes."""
    _, _, t, _, _, _ = _pair("on")
    g = torch.Generator().manual_seed(5)
    node_mask = torch.tensor([[1, 1, 1, 1, 0, 0]], dtype=torch.float32)
    e_mask = t.edge_mask(node_mask)
    z_v = torch.randn(1, N, 2, generator=g)
    z = torch.randn(1, E, 2, generator=g)
    atoms = torch.tensor([[0, 1, 2, 3, 0, 0]])
    node_feat = t._node_feat(z_v, atoms, node_mask)
    if stage == "exist":
        flow, mask = t.flow_exist, e_mask
        cond = {"node_feat": node_feat, "node_mask": node_mask}
    else:
        exist = (torch.rand(1, E, generator=g) < 0.4).long()
        mask = e_mask * exist
        flow = t.flow_bond
        cond = {"node_feat": t._bond_node_feat(node_feat, exist, e_mask,
                                               node_mask),
                "node_mask": node_mask,
                "edge_feat": t._bond_edge_feat(torch.randn(
                    1, E, 2, generator=g), exist, e_mask)}
    _valid_submap_logdet(flow, z, cond, mask)


# -- the task, convert, serving and the CLI -----------------------------------

TASK = dict(dataset="tiny", max_nodes=N, batch_size=4, num_layers_node=2,
            num_layers_edge=2, hidden_dim=16, num_mixtures=3,
            eval_batches_count=1, metric_samples=8, compute_dtype="float32")


def test_task_trains_converts_and_serves(tmp_path):
    """A few CPU steps through the Trainer (loss finite, evals, the final
    sample metrics with the reference's columns, sampled_molecules.json);
    the reference task's weights carried across (a tree of another depth
    refused); the node-count prior's share of the bpd as the reference's;
    the /sample payload."""
    from categoricalnf_tpu_torch.serve import _sample_payload
    from categoricalnf_tpu_torch.training.engine import TrainConfig, Trainer
    _write_npz(tmp_path, "tiny")
    task = tmol.MoleculeTask(**TASK, data_dir=str(tmp_path), device="cpu")
    assert task.name == "molecules_tiny" and task.supports_stage_temperatures
    out = tmp_path / "run"
    final = Trainer(task, TrainConfig(num_steps=4, eval_every=2,
                                      eval_samples=2, final_eval_samples=2,
                                      log_every=2, seed=1,
                                      out_dir=str(out))).train(resume=False)
    assert np.isfinite(final["best_bpd"]) and final["best_bpd"] > 0
    assert {"validity", "validity_ci95", "uniqueness", "novelty",
            "validity_strict", "validity_corrected", "uniqueness_corrected",
            "novelty_corrected", "metric_num_samples"} <= set(final)
    mols = json.load(open(out / "sampled_molecules.json"))
    assert len(mols) == 32 and {"atoms", "bonds", "smiles", "valid",
                                "valid_strict"} == set(mols[0])

    jtask = jmol.MoleculeTask(**TASK, data_dir=str(tmp_path))
    params = _jax_params(jtask.model, 0)
    state = convert.from_jax_params(task, params)
    task.model.load_state_dict(state)
    np.testing.assert_array_equal(
        state["flow_node.layers.2.net.blocks.1.qkv.w"].numpy(),
        params["flow_node"][2]["net"]["blocks"][1]["qkv"]["w"])
    with pytest.raises(ValueError, match="differ"):
        convert.from_jax_params(task, {**params, "flow_bond":
                                       params["flow_bond"][:4]})
    batch = jtask.eval_batches()[0]
    np.testing.assert_allclose(
        task.eval_bpd_extra(batch).numpy(),
        np.asarray(jtask.eval_bpd_extra(jax.tree.map(jnp.asarray, batch))),
        rtol=1e-6)

    payload = _sample_payload(task, torch.Generator().manual_seed(0), 3, 1.0)
    assert len(payload) == 3
    for mol in payload:
        assert set(mol) == {"atoms", "bonds", "smiles", "valid"}
        assert all(0 <= i < j < len(mol["atoms"]) and 1 <= o <= 3
                   for i, j, o in mol["bonds"])


def test_convert_splits_scanned_graphcnf_trees():
    j, params, t, *_ = _pair("on")
    state = convert.from_jax_params(_Holder(t), params)
    np.testing.assert_array_equal(
        state["flow_bond.layers.0.blocks.1.2.net.blocks.0.v2e.w"].numpy(),
        params["flow_bond"][0][2]["net"]["blocks"][0]["v2e"]["w"][1])
    wide = jax.tree.map(lambda a: np.concatenate([a, a], axis=-1),
                        params["flow_exist"])
    with pytest.raises(ValueError, match="shape"):
        convert.from_jax_params(_Holder(t), {**params, "flow_exist": wide})


def test_cli_round_trip(tmp_path, monkeypatch):
    """The CLI trains on the CPU, load_run restores the run, and
    sample_eval takes per-stage temperatures.  The run's final sample
    metrics take 8 molecules, not the task's 1,024, to stay small."""
    import functools

    from categoricalnf_tpu_torch.experiments import molecule_generation
    from categoricalnf_tpu_torch.experiments import sample_eval
    from categoricalnf_tpu_torch.inference import load_run
    monkeypatch.setattr(molecule_generation, "MoleculeTask",
                        functools.partial(tmol.MoleculeTask,
                                          metric_samples=8))
    _write_npz(tmp_path, "tiny")
    out = str(tmp_path / "cli")
    final = molecule_generation.main([
        "--device", "cpu", "--dataset", "tiny", "--data_dir", str(tmp_path),
        "--max_nodes", str(N), "--batch_size", "8", "--num_layers_node",
        "2", "--num_layers_edge", "2", "--num_layers_bond", "4",
        "--hidden_dim", "16", "--num_mixtures", "3", "--node_cond_atoms",
        "--bond_cond_degree", "--num_steps", "2", "--eval_every", "2",
        "--eval_samples", "2", "--log_every", "1", "--compute_dtype",
        "float32", "--out_dir", out])
    assert np.isfinite(final["best_bpd"])
    handle = load_run(out, device="cpu")
    assert handle.task.node_cond_atoms and handle.task.num_layers_bond == 4
    rows = sample_eval.main(["--run", out, "--device", "cpu",
                             "--temperatures", "1.0,0.9:1.0:0.8",
                             "--num_samples", "4"])
    assert [r["temperature"] for r in rows] == [1.0, [0.9, 1.0, 0.8]]
    assert all(0.0 <= r["validity"] <= 1.0 for r in rows)
