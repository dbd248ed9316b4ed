from .analysis import (HW, kernel_roofline, model_flops, roofline_report)

__all__ = ["HW", "kernel_roofline", "model_flops", "roofline_report"]
