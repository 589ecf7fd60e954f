"""Zero-shot evaluation of the port."""
from repro_torch.eval.zero_shot import (  # noqa: F401
    classify,
    evaluate_benchmark,
    evaluate_with_service,
)
