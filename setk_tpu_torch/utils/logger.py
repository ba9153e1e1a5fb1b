"""Timestamped logger with the toolkit's get_logger surface."""

import logging

__all__ = ["get_logger"]

default_format_str = ("%(asctime)s [%(pathname)s:%(lineno)s - "
                      "%(levelname)s ] %(message)s")


def get_logger(name,
               format_str=default_format_str,
               date_format="%Y-%m-%d %H:%M:%S",
               file=False):
    def get_handler(handler):
        handler.setLevel(logging.INFO)
        handler.setFormatter(
            logging.Formatter(fmt=format_str, datefmt=date_format))
        return handler

    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        if file:
            logger.addHandler(get_handler(logging.FileHandler(name)))
        logger.addHandler(get_handler(logging.StreamHandler()))
    return logger
