"""Observability of the port: span timing (:mod:`repro_torch.obs.trace`)."""
