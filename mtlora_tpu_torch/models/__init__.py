"""MTLoRA Swin backbone, HRNet heads and the multi-task assembly."""
