from repro_torch.core.controller import SplitEEController  # noqa: F401
from repro_torch.core.policy import (  # noqa: F401
    BanditState,
    bandit_step,
    init_state,
    run_many,
    run_stream,
    select_arm,
    ucb_index,
)
from repro_torch.core.regret import (  # noqa: F401
    cumulative_regret,
    oracle_policy_metrics,
    per_sample_rewards,
)
from repro_torch.core.baselines import (  # noqa: F401
    confidence_cascade,
    deebert_cascade,
    final_exit,
    random_exit,
)
from repro_torch.core.rewards import (  # noqa: F401
    CostModel, CostTrace, oracle_arm)
from repro_torch.core.thresholds import calibrate_alpha  # noqa: F401
