"""Training of the port: optimizer (train/optim.py), anomaly guard
(train/anomaly.py), the train and eval steps (train/step.py) and the
trainer loop with its command line (train/trainer.py, ``python -m
differential_transformer_replication_tpu_torch.train``)."""
