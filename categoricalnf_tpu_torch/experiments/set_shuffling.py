"""Set-shuffling training CLI of the port (counterpart of
``experiments/set_shuffling/train.py``).

Example, on a machine with a CUDA card (``--device cpu`` runs on the CPU):

    python -m categoricalnf_tpu_torch.experiments.set_shuffling \
        --num_steps 5000 --out_dir runs_torch/set16

The run directory is then served by ``python -m categoricalnf_tpu_torch.serve
--run runs_torch/set16``.  ``--fused`` is accepted and has no effect: on the
card the coupling nets run the fused kernels wherever these take the
shapes.  ``--remat``
recomputes each block's activations in the backward pass; it acts on a
scanned stack only, which a set stack is above 8 layers.
"""

from __future__ import annotations

from categoricalnf_tpu_torch.tasks import SetShufflingTask
from categoricalnf_tpu_torch.utils.cli import default_parser, run_training


def main(argv=None) -> dict:
    p = default_parser("Set shuffling: uniform over permutations")
    p.add_argument("--set_size", type=int, default=16)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--fused", action="store_true")
    args = p.parse_args(argv)
    task = SetShufflingTask(
        set_size=args.set_size, batch_size=args.batch_size,
        encoding_name=args.encoding, encoding_dim=args.encoding_dim,
        num_layers=args.num_layers, hidden_dim=args.hidden_dim,
        num_mixtures=args.num_mixtures, compute_dtype=args.compute_dtype,
        decoder=args.decoder, vardeq_blocks=args.vardeq_blocks,
        vardeq_hidden=args.vardeq_hidden,
        vardeq_mixtures=args.vardeq_mixtures, remat=args.remat,
        device=args.device)
    final = run_training(task, args)
    print(f"optimum {task.analytic_optimum_bpd():.4f} bits/var | "
          f"best {final['best_bpd']:.4f}")
    return final


if __name__ == "__main__":
    main()
