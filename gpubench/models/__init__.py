"""One module a configuration, named as it: ``weight_specs(cfg, traffic)``
(the names, shapes and initial distributions of the weights, in the
port's parameter order), ``port_model(cfg, traffic, device)`` (the port's
model) and ``REFERENCE`` (its plain reference's module)."""
