"""Evaluation: the BLEU half of CodeBLEU (`eval/codebleu.py`) and the
cascade's temperature and band calibration (`eval/calibrate.py`)."""

from deepdfa_tpu_torch.eval.codebleu import corpus_bleu, weighted_corpus_bleu

__all__ = ["corpus_bleu", "weighted_corpus_bleu"]
