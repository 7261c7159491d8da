"""The benchmark's plain reference of the ProPainter nodes.

A frozen copy, in plain PyTorch, of what the two ComfyUI nodes compute:
the node's host preparation (byte quantization, PIL's bicubic resize,
mask dilation, the outpaint canvas), the four stages (RAFT, flow completion,
image propagation, feature propagation with its windows, composite and
overlap blend) and the three networks, with every hand-written kernel
of the program replaced by its arithmetic written out (the correlation
lookup, the modulated deformable conv, the sparse window attention).

It imports nothing of the measured package and nothing of JAX, and it
loads the weights from the same `.jax.npz` files the program reads,
through a layout conversion of its own. It computes in float32 with
TF32 off, one window and one pair of frames at a time where memory asks
for it. Inside `ops.operand_precision("fp8")` the operands and results
of every conv, linear and matrix product are rounded to float8 (e4m3,
per-tensor scale): the control of a bf16 configuration's comparison.
"""
