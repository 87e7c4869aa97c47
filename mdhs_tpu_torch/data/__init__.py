"""The host data path: tokenizer, image decoding, the dataset join and the batch loader."""
