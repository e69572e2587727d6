"""Backbones. Only MobileNet v1 is ported; ResNet, EfficientNet and the hybrid
ViT wait (ROADMAP.md)."""
