"""Dataset rows: the port's own copy of the reference's
`deepdfa_tpu/data/pipeline.py:Example` and a reader of the
`processed/<dataset>/examples.pkl` that `prepare` writes.

The port's `prepare` (`python -m deepdfa_tpu_torch.cli prepare`) pickles
this module's `Example`; the reference's pickles
`deepdfa_tpu.data.pipeline.Example`, which a plain `pickle.load` would
resolve by importing the JAX package. `load_examples` reads both: its
`find_class` maps the reference's class to the port's `Example` and
refuses every other class of `deepdfa_tpu`; other modules resolve as
usual (the file is the program's own output, as with any pickle). The
reference cannot read the port's pickle.
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path

#: the reference's pickled class, by module and name
REFERENCE_EXAMPLE = ("deepdfa_tpu.data.pipeline", "Example")


@dataclasses.dataclass
class Example:
    """One dataset row (reference schema: id, code, vul label, changed lines)."""

    id: int
    code: str
    label: float | None = None
    vuln_lines: frozenset[int] = frozenset()


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) == REFERENCE_EXAMPLE:
            return Example
        if module == "deepdfa_tpu" or module.startswith("deepdfa_tpu."):
            raise pickle.UnpicklingError(
                f"{module}.{name}: the port reads the reference's Example rows only "
                "(loading any other class would import the JAX package)"
            )
        return super().find_class(module, name)


def load_examples(path: str | Path) -> list[Example]:
    """The rows of an `examples.pkl`, as the port's `Example`s."""
    with open(path, "rb") as f:
        rows = _Unpickler(f).load()
    if not isinstance(rows, list) or not all(isinstance(e, Example) for e in rows):
        raise TypeError(f"{path}: expected a list of Example rows")
    return rows
