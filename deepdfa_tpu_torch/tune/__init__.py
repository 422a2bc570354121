"""The autotuner (the port's `deepdfa_tpu/tune/`): a measured search
over the GGNN kernel layouts on the card (`tune.kernel`), ladder fits to
observed batch sizes and token lengths (`tune.ladder`), hardware-keyed
tuned.json records with loud fallbacks (`tune.cache`) and the `cli tune`
drive (`tune.driver`). Off by default: `tune.enabled` only makes the
consumers read the record; the search runs offline.
"""

from deepdfa_tpu_torch.tune.cache import (  # noqa: F401
    hardware_key,
    load_tuned,
    record_for_config,
    save_tuned,
    validate_tuned,
)
from deepdfa_tpu_torch.tune.kernel import (  # noqa: F401
    Candidate,
    enumerate_candidates,
    numerics_verdict,
    search_kernel,
)
from deepdfa_tpu_torch.tune.ladder import (  # noqa: F401
    fit_rungs,
    fit_serve_ladder,
    fit_seq_buckets,
    padding_waste,
)
