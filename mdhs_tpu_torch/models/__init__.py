"""ResNet, BERT and MIBF-Net as ``nn.Module``s with torchvision / HF names."""
