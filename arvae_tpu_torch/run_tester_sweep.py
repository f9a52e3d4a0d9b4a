"""Analyse a trained music run with the frozen-decoder tester.

The half of ``scripts/run_tester_sweep.py`` that draws no plot, on a
run the port's music CLI trained. Run as a module:

    python -m arvae_tpu_torch.run_tester_sweep [--glsr] [--device cuda] [--out DIR]

The run is named by the music CLI's own flags (``-d``, ``--short``,
widths, ``--decoder_type``, ``-r``, ``--beta``, ``--gamma``, ``--delta``,
``--glsr``, ``--rand``; seed 0 when ``--rand`` is not given), and its
checkpoint is restored from ``<models_root>/torch/<repr>/``. Then, at
B=256 on the tester's test split: ``test_model``,
``test_interpretability`` for the five attributes, ``test_interp(n=8)``
and ``test_attr_reg_interpolations(8, dim, 4)`` for each regularised
dim (all four attributes' dims where the run regularises none). The
MIDI files go to ``--out`` (default ``<run_dir>/plots``). One JSON line
is printed: the scores and the files written. ``--device`` defaults to
``cuda``; without a card the script raises unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import json
import math
from typing import Dict, Optional, Sequence, Tuple

from arvae_tpu_torch import train_measure_vae as cli
from arvae_tpu_torch.data.attributes import MUSIC_REG_TYPE
from arvae_tpu_torch.data.bar_dataset import Score
from arvae_tpu_torch.eval.tester import TESTER_ATTRIBUTES, VAETester, VAETesterGLSR

BATCH_SIZE = 256


def tester_of(args, device) -> VAETester:
    """The tester on the run the CLI's flags name, its checkpoint restored."""
    dataset = cli.dataset_of(args)
    seed = 0 if args.rand is None else args.rand
    settings = cli.reg_settings(args)
    glsr_type = settings[2]
    if glsr_type is not None:
        return VAETesterGLSR(dataset, cli.model_of(args, dataset, seed), device,
                             reg_type=cli.GLSR_SUPPORTED[glsr_type],
                             reg_dim=MUSIC_REG_TYPE[glsr_type], gamma=args.gamma, rand=seed,
                             plots_dir=args.out, beta=args.beta)
    trainer = cli.trainer_of(args, dataset, device, seed, settings)
    trainer.load_model()
    return VAETester(trainer, plots_dir=args.out)


def run_surface(tester: VAETester) -> Tuple[Dict, Dict[str, Score]]:
    """The analyses → (the scores and files as one dict, {path: Score})."""
    loss, acc = tester.test_model(batch_size=BATCH_SIZE)
    interp = {attr: list(tester.test_interpretability(BATCH_SIZE, attr))
              for attr in TESTER_ATTRIBUTES}
    written = {f"{tester.plots_dir}/interp_two_point.mid": tester.test_interp(n=8)}
    dims = sorted(set(tester.trainer.hparams.reg_dim)) or sorted(MUSIC_REG_TYPE.values())
    for dim in dims:
        written.update(tester.test_attr_reg_interpolations(num_points=8, dim=dim,
                                                           num_interps=4))
    scores = [loss, acc] + [r2 for _, r2 in interp.values()]
    if not all(math.isfinite(x) for x in scores):
        raise FloatingPointError(f"a score is not finite: loss {loss}, acc {acc}, {interp}")
    result = {"run_dir": tester.trainer.run_dir, "device": str(tester.device),
              "test_loss": loss, "test_acc": acc, "interpretability": interp,
              "files": list(written)}
    return result, written


def main(argv: Optional[Sequence[str]] = None) -> Tuple[VAETester, Dict, Dict[str, Score]]:
    """Runs the analyses; returns (the tester, the printed dict, {path: Score})."""
    p = cli.arg_parser(__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="directory of the MIDI files "
                   "(default <run_dir>/plots)")
    args = p.parse_args(argv)
    tester = tester_of(args, cli.device_of(args))
    result, written = run_surface(tester)
    print(json.dumps(result))
    return tester, result, written


if __name__ == "__main__":
    main()
