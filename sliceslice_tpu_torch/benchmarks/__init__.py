"""The port's benchmark tables: the random needle/haystack size matrix and
the same-host competitor rows beside the port's own."""
