// ray_tpu_torch C++ worker API (header-only): the same macros and the same
// C ABI as ray_tpu/cpp/ray_tpu.h, so a task library's source builds against
// either header and its .so loads under either package.
//
// Reference analog: cpp/include/ray/api.h — the reference lets users
// write tasks and actors in C++ (RAY_REMOTE / ray::Task(...).Remote()).
// Scoped re-base for ray_tpu: tasks and actors are written in C++ and
// compiled into a shared object; the Python driver loads the library
// (ray_tpu_torch.cpp.load_library) and submits them through the normal task
// machinery; worker processes execute the native code in-process
// through a stable C ABI (no pybind11 in this image — ctypes on the
// Python side, plain extern "C" here). Cross-language args/returns are
// raw byte strings (helpers below pack/unpack scalars), mirroring the
// reference's msgpack boundary (cpp/src/ray/runtime/task/task_executor.cc).
//
// Usage (one translation unit):
//
//   #include "ray_tpu.h"
//   using raytpu::Args; using raytpu::Bytes;
//
//   static Bytes add(const Args& a) {
//     return raytpu::bytes_of(raytpu::as<double>(a[0]) +
//                             raytpu::as<double>(a[1]));
//   }
//   RAY_TPU_TASK(add);
//
//   class Counter {
//     int64_t n_ = 0;
//    public:
//     explicit Counter(const Args& a) {
//       if (!a.empty()) n_ = raytpu::as<int64_t>(a[0]);
//     }
//     Bytes add(const Args& a) {
//       n_ += raytpu::as<int64_t>(a[0]);
//       return raytpu::bytes_of(n_);
//     }
//     Bytes get(const Args&) { return raytpu::bytes_of(n_); }
//   };
//   RAY_TPU_ACTOR(Counter);
//   RAY_TPU_METHOD(Counter, add);
//   RAY_TPU_METHOD(Counter, get);
//
//   RAY_TPU_MODULE();   // emits the C ABI, exactly once per library
//
// Build (the -fvisibility flags are REQUIRED when more than one task
// library may load into a process — without them the inline registry
// symbol is emitted STB_GNU_UNIQUE and binds process-globally even
// under RTLD_LOCAL, merging the libraries' registries):
//
//   g++ -O2 -shared -fPIC -std=c++17 \
//       -fvisibility=hidden -fvisibility-inlines-hidden \
//       -o libmytasks.so mytasks.cc
//
// (or just use ray_tpu_torch.cpp.compile_library, which passes them.)

#ifndef RAY_TPU_CPP_API_H_
#define RAY_TPU_CPP_API_H_

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <stdexcept>
#include <string>
#include <string_view>
#include <type_traits>
#include <utility>
#include <vector>

namespace raytpu {

using Bytes = std::string;
using Args = std::vector<std::string_view>;

// Scalar <-> bytes helpers (little-endian memcpy; the Python side's
// ray_tpu_torch.cpp.f64/i64 pack the same way).
template <typename T>
T as(std::string_view b) {
  static_assert(std::is_trivially_copyable_v<T>);
  if (b.size() != sizeof(T)) {
    throw std::invalid_argument("raytpu::as<T>: arg is " +
                                std::to_string(b.size()) + " bytes, want " +
                                std::to_string(sizeof(T)));
  }
  T v;
  std::memcpy(&v, b.data(), sizeof(T));
  return v;
}

template <typename T>
Bytes bytes_of(const T& v) {
  static_assert(std::is_trivially_copyable_v<T>);
  return Bytes(reinterpret_cast<const char*>(&v), sizeof(T));
}

inline Bytes bytes_of(const Bytes& v) { return v; }
inline Bytes bytes_of(std::string_view v) { return Bytes(v); }
inline Bytes bytes_of(const char* v) { return Bytes(v); }

namespace detail {

using TaskFn = std::function<Bytes(const Args&)>;

struct ActorClass {
  std::function<void*(const Args&)> ctor;
  std::function<void(void*)> dtor;
  std::vector<std::string> method_names;  // registration order
  std::map<std::string, std::function<Bytes(void*, const Args&)>> methods;
};

struct Registry {
  std::vector<std::string> task_names;  // registration order
  std::map<std::string, TaskFn> tasks;
  std::vector<std::string> actor_names;
  std::map<std::string, ActorClass> actors;
};

inline Registry& registry() {
  static Registry r;
  return r;
}

inline bool register_task(const char* name, TaskFn fn) {
  auto& r = registry();
  if (r.tasks.emplace(name, std::move(fn)).second) {
    r.task_names.emplace_back(name);
  }
  return true;
}

template <typename Cls>
bool register_actor(const char* name) {
  auto& r = registry();
  auto& ac = r.actors[name];  // may pre-exist if a method registered first
  if (!ac.ctor) {
    r.actor_names.emplace_back(name);
  }
  ac.ctor = [](const Args& a) -> void* { return new Cls(a); };
  ac.dtor = [](void* p) { delete static_cast<Cls*>(p); };
  return true;
}

template <typename Cls>
bool register_method(const char* cls, const char* name,
                     Bytes (Cls::*m)(const Args&)) {
  // operator[] (not .at): RAY_TPU_METHOD may run before RAY_TPU_ACTOR
  // in static-init order — create the entry; rtpu_actor_new rejects
  // classes whose RAY_TPU_ACTOR never ran (ctor unset) as a catchable
  // error rather than letting out_of_range escape a static initializer
  // and terminate the process at dlopen.
  auto& ac = registry().actors[cls];
  if (ac.methods
          .emplace(name,
                   [m](void* p, const Args& a) {
                     return (static_cast<Cls*>(p)->*m)(a);
                   })
          .second) {
    ac.method_names.emplace_back(name);
  }
  return true;
}

inline Args make_args(const uint8_t** args, const size_t* lens,
                      int32_t nargs) {
  Args out;
  out.reserve(nargs > 0 ? nargs : 0);
  for (int32_t i = 0; i < nargs; ++i) {
    out.emplace_back(reinterpret_cast<const char*>(args[i]), lens[i]);
  }
  return out;
}

inline char* dup_cstr(const std::string& s) {
  char* p = static_cast<char*>(std::malloc(s.size() + 1));
  std::memcpy(p, s.c_str(), s.size() + 1);
  return p;
}

inline void emit_bytes(const Bytes& b, uint8_t** out, size_t* out_len) {
  *out = static_cast<uint8_t*>(std::malloc(b.size() ? b.size() : 1));
  std::memcpy(*out, b.data(), b.size());
  *out_len = b.size();
}

}  // namespace detail
}  // namespace raytpu

#define RAY_TPU_TASK(fn)                                       \
  static const bool _rtpu_task_reg_##fn [[maybe_unused]] =     \
      ::raytpu::detail::register_task(#fn, fn)

#define RAY_TPU_ACTOR(Cls)                                     \
  static const bool _rtpu_actor_reg_##Cls [[maybe_unused]] =   \
      ::raytpu::detail::register_actor<Cls>(#Cls)

#define RAY_TPU_METHOD(Cls, m)                                 \
  static const bool _rtpu_meth_reg_##Cls##_##m [[maybe_unused]] = \
      ::raytpu::detail::register_method<Cls>(#Cls, #m, &Cls::m)

// Emits the C ABI the Python loader (ray_tpu_torch/cpp/__init__.py) binds to.
// rc convention: 0 ok, 1 C++ exception (err set), 2 unknown name.
// The ABI is pushed to default visibility explicitly: libraries are
// compiled -fvisibility=hidden (compile_library) so each task library
// keeps a PRIVATE registry — without this, the vague-linkage inline
// `registry()` symbol can interpose across dlopen'd libraries and one
// library enumerates another's tasks (caught by the two-library drive).
#define RAY_TPU_MODULE()                                                      \
  _Pragma("GCC visibility push(default)")                                     \
  extern "C" {                                                                \
  int32_t rtpu_abi_version(void) { return 1; }                                \
  void rtpu_free(void* p) { std::free(p); }                                   \
  int32_t rtpu_task_count(void) {                                             \
    return (int32_t)::raytpu::detail::registry().task_names.size();           \
  }                                                                           \
  const char* rtpu_task_name(int32_t i) {                                     \
    auto& n = ::raytpu::detail::registry().task_names;                        \
    return (i >= 0 && i < (int32_t)n.size()) ? n[i].c_str() : nullptr;        \
  }                                                                           \
  int32_t rtpu_task_invoke(const char* name, const uint8_t** args,            \
                           const size_t* lens, int32_t nargs, uint8_t** out,  \
                           size_t* out_len, char** err) {                     \
    auto& r = ::raytpu::detail::registry();                                   \
    auto it = r.tasks.find(name);                                             \
    if (it == r.tasks.end()) {                                                \
      *err = ::raytpu::detail::dup_cstr(std::string("unknown task: ") +       \
                                        name);                                \
      return 2;                                                               \
    }                                                                         \
    try {                                                                     \
      ::raytpu::Bytes b =                                                     \
          it->second(::raytpu::detail::make_args(args, lens, nargs));         \
      ::raytpu::detail::emit_bytes(b, out, out_len);                          \
      return 0;                                                               \
    } catch (const std::exception& e) {                                       \
      *err = ::raytpu::detail::dup_cstr(e.what());                            \
      return 1;                                                               \
    } catch (...) {                                                           \
      *err = ::raytpu::detail::dup_cstr("unknown C++ exception");             \
      return 1;                                                               \
    }                                                                         \
  }                                                                           \
  int32_t rtpu_actor_count(void) {                                            \
    return (int32_t)::raytpu::detail::registry().actor_names.size();          \
  }                                                                           \
  const char* rtpu_actor_name(int32_t i) {                                    \
    auto& n = ::raytpu::detail::registry().actor_names;                       \
    return (i >= 0 && i < (int32_t)n.size()) ? n[i].c_str() : nullptr;        \
  }                                                                           \
  int32_t rtpu_actor_method_count(const char* cls) {                          \
    auto& r = ::raytpu::detail::registry();                                   \
    auto it = r.actors.find(cls);                                             \
    return it == r.actors.end() ? -1                                          \
                                : (int32_t)it->second.method_names.size();    \
  }                                                                           \
  const char* rtpu_actor_method_name(const char* cls, int32_t i) {            \
    auto& r = ::raytpu::detail::registry();                                   \
    auto it = r.actors.find(cls);                                             \
    if (it == r.actors.end()) return nullptr;                                 \
    auto& n = it->second.method_names;                                        \
    return (i >= 0 && i < (int32_t)n.size()) ? n[i].c_str() : nullptr;        \
  }                                                                           \
  void* rtpu_actor_new(const char* cls, const uint8_t** args,                 \
                       const size_t* lens, int32_t nargs, char** err) {       \
    auto& r = ::raytpu::detail::registry();                                   \
    auto it = r.actors.find(cls);                                             \
    if (it == r.actors.end() || !it->second.ctor) {                           \
      *err = ::raytpu::detail::dup_cstr(                                      \
          std::string("unknown actor (missing RAY_TPU_ACTOR?): ") + cls);     \
      return nullptr;                                                         \
    }                                                                         \
    try {                                                                     \
      return it->second.ctor(                                                 \
          ::raytpu::detail::make_args(args, lens, nargs));                    \
    } catch (const std::exception& e) {                                       \
      *err = ::raytpu::detail::dup_cstr(e.what());                            \
      return nullptr;                                                         \
    } catch (...) {                                                           \
      *err = ::raytpu::detail::dup_cstr("unknown C++ exception");             \
      return nullptr;                                                         \
    }                                                                         \
  }                                                                           \
  int32_t rtpu_actor_invoke(void* handle, const char* cls,                    \
                            const char* method, const uint8_t** args,         \
                            const size_t* lens, int32_t nargs, uint8_t** out, \
                            size_t* out_len, char** err) {                    \
    auto& r = ::raytpu::detail::registry();                                   \
    auto it = r.actors.find(cls);                                             \
    if (it == r.actors.end()) {                                               \
      *err = ::raytpu::detail::dup_cstr(std::string("unknown actor: ") +      \
                                        cls);                                 \
      return 2;                                                               \
    }                                                                         \
    auto mit = it->second.methods.find(method);                               \
    if (mit == it->second.methods.end()) {                                    \
      *err = ::raytpu::detail::dup_cstr(std::string("unknown method: ") +     \
                                        cls + "." + method);                  \
      return 2;                                                               \
    }                                                                         \
    try {                                                                     \
      ::raytpu::Bytes b = mit->second(                                        \
          handle, ::raytpu::detail::make_args(args, lens, nargs));            \
      ::raytpu::detail::emit_bytes(b, out, out_len);                          \
      return 0;                                                               \
    } catch (const std::exception& e) {                                       \
      *err = ::raytpu::detail::dup_cstr(e.what());                            \
      return 1;                                                               \
    } catch (...) {                                                           \
      *err = ::raytpu::detail::dup_cstr("unknown C++ exception");             \
      return 1;                                                               \
    }                                                                         \
  }                                                                           \
  void rtpu_actor_delete(const char* cls, void* handle) {                     \
    auto& r = ::raytpu::detail::registry();                                   \
    auto it = r.actors.find(cls);                                             \
    if (it != r.actors.end() && handle) it->second.dtor(handle);              \
  }                                                                           \
  }                                                                           \
  _Pragma("GCC visibility pop")                                               \
  static_assert(true, "")

#endif  // RAY_TPU_CPP_API_H_
