"""The plain reference: ViT and the CIFAR ResNet forward, their loss,
their gradients by autograd, and SGD with momentum, in plain PyTorch.

It imports ``torch`` alone: nothing of ``jax``, of the JAX package or of
``tpu_dist_torch``. Where the port's arithmetic is part of the model's
definition (the BatchNorm formula of the JAX package, the crop and
normalisation of the fused epoch, tanh GELU, LayerNorm's eps), it is a
copy written out here. Weights are a ``{name: tensor}`` dict.

``precision`` is ``"f32"`` (float32 with TF32 off: the reference),
``"fp8"`` (the control: every product's operands rounded to e4m3 and its
gradients to e5m2, each with a per-tensor scale, accumulated in float32,
the precision below the bfloat16 that the configurations state) or
``"bf16"`` (the same at bfloat16: a witness of how far bf16 rounding alone
moves the compared numbers) or ``"fp8_operands"`` (the products' operands
in fp8, the activations in float32: the control without its rounded
activations).
"""
