from .cli import script_main

if __name__ == "__main__":
    script_main()
