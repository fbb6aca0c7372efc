"""Molecule-generation training CLI of the port (counterpart of
``experiments/molecule_generation/train.py``, the same flags): GraphCNF on a
preprocessed dataset or on the in-memory synthetic molecules.

Example, on a machine with a CUDA card (``--device cpu`` runs on the CPU):

    python -m categoricalnf_tpu_torch.experiments.molecule_generation \
        --dataset synthetic --max_nodes 24 --hidden_dim 192 \
        --num_layers_edge 6 --batch_size 128 --num_steps 50000 \
        --out_dir runs_torch/molecules

The run directory is then served by ``python -m categoricalnf_tpu_torch.serve
--run runs_torch/molecules``.
"""

from __future__ import annotations

from categoricalnf_tpu_torch.tasks import MoleculeTask
from categoricalnf_tpu_torch.utils.cli import default_parser, run_training


def main(argv=None) -> dict:
    p = default_parser("GraphCNF molecule generation")
    p.add_argument("--dataset", type=str, default="synthetic",
                   help="dataset name: looks for {name}.npz under "
                   "--data_dir / $CNF_DATA_DIR; a missing .npz is an error "
                   "for any name but 'synthetic' (the in-memory generator)")
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--max_nodes", type=int, default=38)
    p.add_argument("--num_layers_node", type=int, default=4)
    p.add_argument("--num_layers_edge", type=int, default=4)
    p.add_argument("--num_layers_bond", type=int, default=0,
                   help="bond-stage flow depth (0 = follow num_layers_edge)")
    p.add_argument("--edge_degree_norm", type=str, default="nodes",
                   choices=["nodes", "live_edges"],
                   help="EdgeGNN edge->node normaliser; live_edges scales "
                   "bond-stage messages by the live-bond degree")
    p.add_argument("--bond_cond_exist", action="store_true",
                   help="condition the bond stage on decoded existence "
                   "one-hots alongside z_e1")
    p.add_argument("--node_cond_atoms", action="store_true",
                   help="condition stages 2-3 on decoded atom-type "
                   "one-hots alongside z_v")
    p.add_argument("--bond_cond_degree", action="store_true",
                   help="condition the bond stage's node stream on the "
                   "decoded degree one-hot (the valence budget)")
    p.set_defaults(batch_size=64)
    args = p.parse_args(argv)
    task = MoleculeTask(
        dataset=args.dataset, data_dir=args.data_dir,
        max_nodes=args.max_nodes, batch_size=args.batch_size,
        num_layers_node=args.num_layers_node,
        num_layers_edge=args.num_layers_edge,
        num_layers_bond=args.num_layers_bond,
        hidden_dim=args.hidden_dim, num_mixtures=args.num_mixtures,
        edge_degree_norm=args.edge_degree_norm,
        bond_cond_exist=args.bond_cond_exist,
        node_cond_atoms=args.node_cond_atoms,
        bond_cond_degree=args.bond_cond_degree,
        compute_dtype=args.compute_dtype, device=args.device)
    final = run_training(task, args)
    print(f"best bpd {final['best_bpd']:.4f} | "
          f"validity {final.get('validity', float('nan')):.3f} "
          f"(corrected {final.get('validity_corrected', float('nan')):.3f}) | "
          f"uniqueness {final.get('uniqueness', float('nan')):.3f} | "
          f"novelty {final.get('novelty', float('nan')):.3f}")
    return final


if __name__ == "__main__":
    main()
