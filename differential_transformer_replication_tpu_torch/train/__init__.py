"""Training of the port: optimizer (train/optim.py), anomaly guard with
its rollback and abort (train/anomaly.py), the train and eval steps
(train/step.py), checkpoints (train/checkpoint.py, train/ckpt_writer.py),
the metric logger (train/metrics.py), the step watchdog
(train/watchdog.py) and the trainer loop with its command line
(train/trainer.py, ``python -m
differential_transformer_replication_tpu_torch.train``)."""
