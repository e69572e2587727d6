"""Backbones: MobileNet v1, ResNet (18, with and without BlurPool),
EfficientNet (b0 to b4) and the hybrid ViT."""
