"""Graph-coloring training CLI of the port (counterpart of
``experiments/graph_coloring/train.py``).

Example, on a machine with a CUDA card (``--device cpu`` runs on the CPU):

    python -m categoricalnf_tpu_torch.experiments.graph_coloring \
        --num_steps 20000 --out_dir runs_torch/coloring

The run directory is then served by ``python -m categoricalnf_tpu_torch.serve
--run runs_torch/coloring``.
"""

from __future__ import annotations

from categoricalnf_tpu_torch.tasks import GraphColoringTask
from categoricalnf_tpu_torch.utils.cli import default_parser, run_training


def main(argv=None) -> dict:
    p = default_parser("Graph 3-coloring with RGCN couplings")
    p.add_argument("--min_nodes", type=int, default=10)
    p.add_argument("--max_nodes", type=int, default=20)
    p.add_argument("--num_colors", type=int, default=3)
    p.add_argument("--edge_prob", type=float, default=0.25)
    p.set_defaults(batch_size=256, encoding_dim=2, num_layers=6)
    args = p.parse_args(argv)
    task = GraphColoringTask(
        min_nodes=args.min_nodes, max_nodes=args.max_nodes,
        num_colors=args.num_colors, edge_prob=args.edge_prob,
        batch_size=args.batch_size, encoding_dim=args.encoding_dim,
        num_layers=args.num_layers, hidden_dim=args.hidden_dim,
        num_mixtures=args.num_mixtures, compute_dtype=args.compute_dtype,
        device=args.device)
    final = run_training(task, args)
    print(f"best bpd {final['best_bpd']:.4f} | "
          f"validity {final.get('coloring_validity', float('nan')):.3f}")
    return final


if __name__ == "__main__":
    main()
