from repro_torch.data.synthetic import DOMAINS, make_dataset  # noqa: F401
from repro_torch.data.stream import (  # noqa: F401
    OnlineStream,
    batch_iterator,
    microbatches,
)
from repro_torch.data.profiles import (  # noqa: F401
    DriftSpec,
    PROFILE_DATASETS,
    ProfileSpec,
    simulate_drift_profiles,
    simulate_exit_profiles,
)
