"""Evaluation: CodeBLEU (`eval/codebleu.py`: its n-gram halves and its
syntax and dataflow matches over nine languages, with the digit-exact
java/c# dataflow of `eval/dfg_parity.py`) and the cascade's temperature
and band calibration (`eval/calibrate.py`)."""

from deepdfa_tpu_torch.eval.codebleu import (
    corpus_bleu,
    corpus_dataflow_match,
    corpus_syntax_match,
    get_codebleu,
    weighted_corpus_bleu,
)

__all__ = ["corpus_bleu", "corpus_dataflow_match", "corpus_syntax_match", "get_codebleu",
           "weighted_corpus_bleu"]
