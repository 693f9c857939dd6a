"""The paper's benchmark CNNs (``cnn``) and parameter conversion (``convert``)."""
