"""Character-level language-modeling CLI of the port (counterpart of
``experiments/language_modeling/train.py``): PTB, text8, or the synthetic
Markov corpus they fall back to without their files.

Example, on a machine with a CUDA card (``--device cpu`` runs on the CPU),
``runs/lm_v6``'s model:

    python -m categoricalnf_tpu_torch.experiments.language_modeling \
        --corpus synthetic --encoding_dim 4 --num_layers 4 \
        --num_mixtures 32 --prior hmm --lr 5e-4 --eval_every 3000 \
        --num_steps 60000 --out_dir runs_torch/lm_v6

The run directory is then served by ``python -m categoricalnf_tpu_torch.serve
--run runs_torch/lm_v6``, whose ``/sample`` returns strings.
"""

from __future__ import annotations

from categoricalnf_tpu_torch.tasks import LanguageModelingTask
from categoricalnf_tpu_torch.utils.cli import default_parser, run_training


def main(argv=None) -> dict:
    p = default_parser("Character-level language modeling")
    p.add_argument("--corpus", type=str, default="ptb",
                   choices=["ptb", "text8", "synthetic"])
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--seq_len", type=int, default=256)
    p.add_argument("--lstm_layers", type=int, default=2,
                   help="depth of the causal backbone")
    p.add_argument("--net", type=str, default="lstm",
                   choices=["lstm", "transformer"],
                   help="causal coupling backbone: LSTMs, or causal "
                   "transformers with KV-cache sampling")
    p.add_argument("--input_feats", type=int, default=0,
                   help="V-component soft-classifier features of z_{t-1} "
                   "fed to the causal nets (0 = off)")
    p.add_argument("--prior", type=str, default="logistic",
                   choices=["logistic", "gaussian", "hmm"],
                   help="top-of-flow prior; hmm = a learned latent "
                   "state-space prior")
    p.add_argument("--prior_states", type=int, default=32)
    p.set_defaults(batch_size=128, encoding_dim=3, num_layers=2,
                   hidden_dim=512, num_mixtures=16)
    args = p.parse_args(argv)
    task = LanguageModelingTask(
        corpus_name=args.corpus, data_dir=args.data_dir,
        seq_len=args.seq_len, batch_size=args.batch_size,
        encoding_name=args.encoding, encoding_dim=args.encoding_dim,
        num_layers=args.num_layers, hidden_dim=args.hidden_dim,
        lstm_layers=args.lstm_layers, num_mixtures=args.num_mixtures,
        net=args.net, input_feats=args.input_feats, prior=args.prior,
        prior_states=args.prior_states, compute_dtype=args.compute_dtype,
        device=args.device)
    final = run_training(task, args)
    opt = task.analytic_optimum_bpd()
    extra = f" | analytic optimum {opt:.4f}" if opt else ""
    print(f"best {final['best_bpd']:.4f} bits/char{extra}")
    return final


if __name__ == "__main__":
    main()
