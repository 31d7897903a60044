"""The LM side: the dense GQA decoders (smollm-360m, h2o-danube-1.8b,
qwen1.5-4b) in the reference's parameter and cache trees."""
