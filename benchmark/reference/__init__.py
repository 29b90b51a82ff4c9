"""The plain reference: float32 PyTorch of the two segmentors, the Tiny
discriminator, the per-batch transform and the adversarial v1 step.

It imports nothing of the program.  ``lowp.fp8`` is the control: the same
reference with every convolution's inputs rounded to float8.
"""
