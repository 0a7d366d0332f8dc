from repro_torch.data.synthetic import DOMAINS, make_dataset  # noqa: F401
from repro_torch.data.stream import OnlineStream, microbatches  # noqa: F401
