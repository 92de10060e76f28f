"""The LM-scale model path: configuration schema, layers, rwkv, model."""
