"""ResNet, BERT, MIBF-Net and the baseline family as ``nn.Module``s with torchvision / HF / reference names."""
