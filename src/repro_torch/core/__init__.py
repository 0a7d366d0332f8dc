from repro_torch.core.controller import SplitEEController  # noqa: F401
from repro_torch.core.policy import (  # noqa: F401
    BanditState, init_state, select_arm, ucb_index)
from repro_torch.core.rewards import (  # noqa: F401
    CostModel, CostTrace, oracle_arm)
