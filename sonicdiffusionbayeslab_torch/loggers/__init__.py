from sonicdiffusionbayeslab_torch.loggers.logger import Logger, LocalRunLogger, WandbLogger  # noqa: F401
