"""The paper's benchmark CNNs (``cnn``), the decoder LMs (``lm``, with
``config``, ``layers``, ``attention`` and ``ssm``) and parameter conversion
(``convert``)."""
