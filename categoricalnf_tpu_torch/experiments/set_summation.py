"""Set-summation training CLI of the port (counterpart of
``experiments/set_summation/train.py``): the mixture-against-dequantization
ablation task.

Example, on a machine with a CUDA card (``--device cpu`` runs on the CPU):

    python -m categoricalnf_tpu_torch.experiments.set_summation \
        --encoding vardeq --num_steps 12000 --out_dir runs_torch/sum_vardeq

The run directory is then served by ``python -m categoricalnf_tpu_torch.serve
--run runs_torch/sum_vardeq``.
"""

from __future__ import annotations

from categoricalnf_tpu_torch.tasks import SetSummationTask
from categoricalnf_tpu_torch.utils.cli import default_parser, run_training


def main(argv=None) -> dict:
    p = default_parser("Set summation: sum-constrained sequences")
    p.add_argument("--set_size", type=int, default=16)
    p.add_argument("--num_categories", type=int, default=10)
    p.add_argument("--target_sum", type=int, default=0)
    args = p.parse_args(argv)
    task = SetSummationTask(
        set_size=args.set_size, num_categories=args.num_categories,
        target_sum=args.target_sum, batch_size=args.batch_size,
        encoding_name=args.encoding, encoding_dim=args.encoding_dim,
        num_layers=args.num_layers, hidden_dim=args.hidden_dim,
        num_mixtures=args.num_mixtures, compute_dtype=args.compute_dtype,
        decoder=args.decoder, vardeq_blocks=args.vardeq_blocks,
        vardeq_hidden=args.vardeq_hidden,
        vardeq_mixtures=args.vardeq_mixtures, device=args.device)
    final = run_training(task, args)
    print(f"optimum {task.analytic_optimum_bpd():.4f} bits/var | "
          f"best {final['best_bpd']:.4f}")
    return final


if __name__ == "__main__":
    main()
