"""One reader a metric, named as the metric: ``read(run)`` takes the
:class:`gpubench.run.Run` of a finished window and returns the metric's
value, or None where the cell has nothing for it to read. A device metric
reads None off the card."""
